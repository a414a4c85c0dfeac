"""repro_torch's hybrid family (the Mamba mixer of ``models/ssm.py`` with
attention and MoE layers) against the JAX package.

Smoke jamba-1.5-large-398b (8 layers, a period of 4: Mamba + MLP,
Mamba + MoE, attention + MLP, Mamba + MoE; d_model 64, 4 experts, top-2;
Mamba d_state 4, head_dim 16, chunk 8), f32, with the JAX parameters
carried across by ``from_jax_params`` and the same numpy inputs.

* The config and its smoke config equal JAX's field for field, and so do
  ``layer_pattern``, ``mamba_specs`` and the full-width parameter count.
  A hybrid config cut below one period takes the period's first layers in
  the port (the card's depth cut) and raises in JAX; a non-multiple above
  one period raises in both.
* ``Runtime.ppermute_prev_shard`` sends rank p's tensor to p + 1 (zeros to
  rank 0) and its backward is the transposed permutation; ``_causal_conv``
  and ``mamba_block`` match JAX's in local mode within 2e-5 of the largest
  magnitude, and the conv over ``ThreadMesh`` ranks with its halo equals
  the one-rank conv, forward and backward.
* Loss and every gradient leaf within 2e-3 (``check_spmd_model``'s bound,
  with its capacity factor of 8.0, so no token is dropped): at P = 1
  against the JAX local mode, and on ``ThreadMesh`` (c, r, data) =
  (2, 1, 2), (1, 4, 2) and (2, 2, 1) against the JAX spmd island at the
  same mesh under ``default``, ``fsdp`` and ``tp``. Three train steps at
  (2, 1, 2) against JAX ``build_train_step``, each from the parameters
  JAX's starts from (AdamW's first update turns f32 noise in near-zero
  gradients into full steps), with every rank's expert choices equal.
* Serving: the prefill's attention K/V and Mamba states at P = 1 and at
  (2, 1, 2) against the JAX ``lm_prefill`` cache within 2e-5 of their
  largest magnitude; one decode step from a zero cache at (c, data) =
  (2, 2) gives ``serve_hybrid``'s tokens; ``_mamba_decode`` matches JAX's
  given the same cache; ``--legacy`` at P = 1 and 4: its first token is the
  JAX prefill island's and its later tokens the port's full-forward argmax
  (capacity lifted, as ``test_serving_consistency`` lifts it).
* The reference fault the port does not copy: JAX's prefill caches the
  conv's SiLU'd output as the conv state (``repro/models/ssm.py:194,
  :217``) where its decode step convolves raw inputs
  (``repro/serve/step.py:131-134``); the port caches the raw inputs, and
  its prefill then decode gives the full-forward argmax at
  ``test_serving_consistency``'s S = 17, where JAX's does not.
* The engine, the gateway and ``launch.serve`` without ``--legacy``
  refuse the family with the JAX engine's reason; both launchers run the
  smoke config; a checkpoint round-trips through the JAX package's format.
* The JAX references that need a mesh run in one child process with 8
  forced host devices, started by the first test so it overlaps the rest.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.configs.base import RunConfig as JaxRunConfig
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.engine import paged_cache as jax_paged_cache
from repro.models import blocks as jax_blocks
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_transformer
from repro.models.factory import build_model as jax_build_model
from repro.serve import step as jax_serve_step
from repro.train import step as jax_train_step
from repro_torch import engine as torch_engine
from repro_torch.configs import registry
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.dist import checkpoint
from repro_torch.dist.comm import SingleComm, ThreadMesh
from repro_torch.engine import sampling
from repro_torch.launch import serve
from repro_torch.models import blocks, moe, ssm, transformer
from repro_torch.models.factory import (Model, build_model,
                                        from_jax_params, jax_tree,
                                        load_jax_tree, to_jax_layout)
from repro_torch.optim import adamw
from repro_torch.plan import make_plan, make_serve_plan
from repro_torch.serve import kv_cache
from repro_torch.serve import step as serve_step
from repro_torch.train import step as train_step
from test_torch_train_sp import mesh_whole_grads

ARCH = "jamba-1.5-large-398b"
SEQ, BATCH = 32, 2
TOL = 2e-3                               # check_spmd_model's bound
BLOCK_TOL = 2e-5                         # tests/test_ssm_and_roofline.py's
CAPACITY = 8.0                           # check_spmd_model's, no drops
MESHES = [(2, 1, 2), (1, 4, 2), (2, 2, 1)]
RULE_SETS = ["default", "fsdp", "tp"]
ISLAND = (2, 1, 2)
SERVE_MESH = (2, 1, 2)                   # serve_hybrid's (c, r, data)
LEGACY = {"batch": 3, "prompt": 16, "gen": 5}
LEGACY_SP = (1, 4)                       # n_devices of the --legacy runs
CONSISTENCY_S = 17                       # test_serving_consistency's S
# lr 1e-3 as the port's MoE step tests (test_torch_moe.ADAM_STEP)
ADAM_STEP = dict(learning_rate=1e-3, warmup_steps=0)
_CTX = {}


def _lifted(cfg, factor=CAPACITY):
    """``cfg`` with the MoE capacity factor lifted (no token dropped)."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor))


def _ctx():
    if not _CTX:
        cfg_j = jax_registry.get_smoke(ARCH)
        model_j = jax_build_model(cfg_j)
        tree = jax.tree.map(np.asarray, model_j.init(jax.random.PRNGKey(0)))
        rng = np.random.default_rng(0)
        batch = {n: rng.integers(0, cfg_j.vocab_size, (BATCH, SEQ),
                                 dtype=np.int32)
                 for n in ("tokens", "labels")}
        _CTX.update(cfg_j=cfg_j, model_j=model_j, tree=tree, batch=batch,
                    lifted_j=jax_build_model(_lifted(cfg_j)),
                    cfg=registry.get_smoke(ARCH))
    return _CTX


def _key(c, r, data):
    return f"{c}{r}{data}"


def _assert_scaled(got, want, what=""):
    """Within ``BLOCK_TOL`` of ``want``'s largest magnitude."""
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= BLOCK_TOL * max(float(np.abs(want).max()), 1.0), (what, err)


def _legacy_tokens(vocab):
    rng = np.random.default_rng(1)
    return rng.integers(0, vocab, (LEGACY["batch"], LEGACY["prompt"]))


def _serve_tokens(vocab):
    """``check_spmd_serve``'s decode tokens."""
    return np.asarray(jax.random.randint(jax.random.PRNGKey(3), (2, 1), 0,
                                         vocab, jnp.int32))


def _jax_local_rt(model_j, seq=SEQ, kind="train"):
    return dataclasses.replace(jax_train_step.make_runtime(
        model_j, JaxRunConfig(c=1, seq_scheme="contiguous"),
        JaxShapeConfig("t", seq, BATCH, kind), mode="local"), batch_axes=())


# ---------------------------------------------------------------------------
# the JAX references on a mesh, in one child process with 8 host devices
# ---------------------------------------------------------------------------

def jax_references():
    """Everything the port is held against that needs a JAX mesh, as a
    flat dict of numpy arrays (run in the child process)."""
    from repro.dist import meshes
    from repro.optim import adamw as jax_adamw
    from repro.plan import make_serve_plan as jax_make_serve_plan
    from repro.serve import kv_cache as jax_kv_cache

    out = {}
    ctx = _ctx()
    cfg, lifted = ctx["cfg_j"], ctx["lifted_j"]
    params = jax.tree.map(jnp.asarray, ctx["tree"])
    shape = JaxShapeConfig("test", seq_len=SEQ, global_batch=BATCH,
                           kind="train")
    for c, r, data in MESHES:
        mesh = meshes.local_mesh_for_tests(c=c, r=r, data=data)
        for rules in RULE_SETS:
            fn, _ = jax_train_step.build_value_and_grad_fn(
                lifted, mesh, JaxRunConfig(c=c, seq_scheme="zigzag",
                                           sharding_rules=rules), shape)
            loss, grads = jax.jit(fn)(params, ctx["batch"])
            key = f"{_key(c, r, data)}|{rules}"
            out[f"{key}|loss"] = np.asarray(loss, np.float32)
            for path, g in jax.tree_util.tree_leaves_with_path(grads):
                out[f"{key}|{jax.tree_util.keystr(path)}"] = \
                    np.asarray(g, np.float32)

    # three train steps (check_spmd_train_step) on the island's mesh:
    # each step's metrics, the parameters it starts from and every rank's
    # expert choices (``jax.lax.top_k``'s, through a debug callback)
    c, r, data = ISLAND
    mesh = meshes.local_mesh_for_tests(c=c, r=r, data=data)
    seen = []
    top_k = jax.lax.top_k

    def recording_top_k(x, k):
        vals, sel = top_k(x, k)
        jax.debug.callback(lambda s: seen.append(choice_key(s)), sel)
        return vals, sel

    jax.lax.top_k = recording_top_k
    try:
        jstep, _ = jax_train_step.build_train_step(
            lifted, mesh, JaxRunConfig(c=c, seq_scheme="zigzag"), shape,
            jax_adamw.AdamWConfig(**ADAM_STEP))
        p = jax.tree.map(jnp.array, ctx["tree"])   # the step donates them
        opt = jax_adamw.init_state(p, jax_adamw.AdamWConfig(**ADAM_STEP))
        metrics = []
        for i in range(3):
            for path, leaf in jax.tree_util.tree_leaves_with_path(p):
                out[f"steps|{i}|{jax.tree_util.keystr(path)}"] = \
                    np.asarray(leaf)
            seen.clear()
            p, opt, m = jstep(p, opt, ctx["batch"])
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
            out[f"steps|{i}|choices"] = np.asarray(sorted(set(seen)))
    finally:
        jax.lax.top_k = top_k
    out["steps"] = np.asarray(metrics)

    # the prefill's cache at P = 1 (local mode) and on the island's mesh
    model = ctx["model_j"]
    tokens = ctx["batch"]["tokens"]
    pshape = JaxShapeConfig("t", SEQ, BATCH, "prefill")
    rt_l = _jax_local_rt(model, kind="prefill")
    tok, cache = jax.jit(lambda p_, t: jax_serve_step.lm_prefill(
        rt_l, p_, {"tokens": t}, cfg))(params, tokens)
    out["prefill|1|tok"] = np.asarray(tok)
    for path, leaf in jax.tree_util.tree_leaves_with_path(cache):
        out[f"prefill|1|{jax.tree_util.keystr(path)}"] = np.asarray(leaf)
    jprefill, _ = jax_serve_step.build_prefill_step(
        model, mesh, JaxRunConfig(c=c, seq_scheme="contiguous"), pshape)
    tok, cache = jprefill(params, {"tokens": tokens})
    out[f"prefill|{_key(*ISLAND)}|tok"] = np.asarray(tok)
    for path, leaf in jax.tree_util.tree_leaves_with_path(cache):
        out[f"prefill|{_key(*ISLAND)}|{jax.tree_util.keystr(path)}"] = \
            np.asarray(leaf)

    # serve_hybrid: one decode step at (c, data) = (2, 2) and in local mode
    c, r, data = SERVE_MESH
    mesh = meshes.local_mesh_for_tests(c=c, r=r, data=data)
    dshape = JaxShapeConfig("t", seq_len=SEQ, global_batch=2, kind="decode")
    run_cfg = JaxRunConfig(c=c, seq_scheme="contiguous")
    zero = jax_kv_cache.init_cache(cfg, 2, SEQ)
    toks = _serve_tokens(cfg.vocab_size)
    jdecode, _ = jax_serve_step.build_decode_step(model, mesh, run_cfg,
                                                  dshape)
    out["serve|spmd"] = np.asarray(jdecode(params, zero, toks)[0])
    rt_l = dataclasses.replace(jax_train_step.make_runtime(
        model, run_cfg, dshape, mode="local"), batch_axes=())
    out["serve|local"] = np.asarray(jax.jit(
        lambda: jax_serve_step.lm_decode_step(rt_l, params, zero, toks, cfg,
                                              SEQ - 1))()[0])

    # --legacy's first tokens: the JAX prefill island of each plan
    legacy = jnp.asarray(_legacy_tokens(cfg.vocab_size), jnp.int32)
    for n in LEGACY_SP:
        plan = jax_make_serve_plan(lifted.cfg, arch=ARCH, n_devices=n,
                                   c=2 if n > 1 else 1)
        jprefill, _ = jax_serve_step.build_prefill_step(
            lifted, plan.build_mesh(), plan.run_config(),
            JaxShapeConfig("serve", LEGACY["prompt"], LEGACY["batch"],
                           "prefill"))
        out[f"legacy|{n}"] = np.asarray(jprefill(params,
                                                 {"tokens": legacy})[0])
    return out


_JAX_CHILD = r"""
import sys
import numpy as np
sys.path.insert(0, "tests")
from test_torch_hybrid import jax_references
np.savez(sys.argv[1], **jax_references())
"""


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = tmp_path_factory.mktemp("hybrid") / "references.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(root, "src"))
    proc = subprocess.Popen([sys.executable, "-c", _JAX_CHILD, str(path)],
                            cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    state = {}

    def load():
        if "want" not in state:
            _, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stderr[-4000:]
            state["want"] = dict(np.load(path))
        return state["want"]

    try:
        yield load
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


# ---------------------------------------------------------------------------
# configs, the layer pattern and the depth cut
# ---------------------------------------------------------------------------

def _meta_model(cfg):
    return Model(cfg, lambda s: torch.empty(s.shape, device="meta"))


def test_configs_equal_jax(references):
    """Field for field, full and smoke (this test also starts the JAX
    child process); the period and each layer's mixer and MLP are JAX's."""
    for cfg, cfg_j in ((registry.get(ARCH), jax_registry.get(ARCH)),
                       (registry.get_smoke(ARCH),
                        jax_registry.get_smoke(ARCH))):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
        assert [cfg.mixer_on_layer(i) for i in range(cfg.num_layers)] == \
            [cfg_j.mixer_on_layer(i) for i in range(cfg.num_layers)]
        assert transformer.layer_pattern(cfg) == \
            jax_transformer.layer_pattern(cfg_j)
    assert transformer.layer_pattern(registry.get(ARCH)) == [
        ("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"),
        ("mamba", "moe"), ("attn", "mlp"), ("mamba", "moe"),
        ("mamba", "mlp"), ("mamba", "moe")]
    assert transformer.layer_pattern(registry.get_smoke(ARCH)) == [
        ("mamba", "mlp"), ("mamba", "moe"), ("attn", "mlp"),
        ("mamba", "moe")]
    assert transformer.has_moe(registry.get(ARCH))
    # the encoder-decoder (§A8 d) and VLM (§A8 e) families are ported
    # since: JAX's configs
    assert dataclasses.asdict(registry.get_smoke("paligemma-3b")) == \
        dataclasses.asdict(jax_registry.get_smoke("paligemma-3b"))
    assert dataclasses.asdict(registry.get_smoke("seamless-m4t-large-v2")) \
        == dataclasses.asdict(jax_registry.get_smoke("seamless-m4t-large-v2"))


def test_specs_and_parameter_counts():
    """``mamba_specs`` leaf for leaf against JAX's; the full-width count
    equals JAX's; the Mamba mixer and the card's cuts (the first five
    layers, and the first layer) at their reckoned sizes."""
    cfg, cfg_j = registry.get(ARCH), jax_registry.get(ARCH)
    specs, specs_j = ssm.mamba_specs(cfg), jax_ssm.mamba_specs(cfg_j)
    assert sorted(specs) == sorted(specs_j)
    for name in specs:
        a, b = specs[name], specs_j[name]
        if isinstance(a, dict):
            a, b = a["scale"], b["scale"]
        assert (a.shape, a.axes, a.init, a.scale) == \
            (b.shape, b.axes, b.init, b.scale), name
    want = jax_build_model(cfg_j).param_count()
    assert _meta_model(cfg).param_count() == want
    model5 = _meta_model(dataclasses.replace(cfg, num_layers=5))
    mamba = sum(p.numel() for p in model5.layers[0].mixer.parameters())
    assert 405.0e6 < mamba < 405.2e6
    assert 23.9e9 < model5.param_count() < 24.1e9
    model1 = _meta_model(dataclasses.replace(cfg, num_layers=1))
    assert 2.07e9 < model1.param_count() < 2.09e9


@pytest.mark.parametrize("layers", [1, 3, 5, 7])
def test_a_cut_below_one_period_takes_its_first_layers(layers):
    """The port-only depth cut: the period's first ``layers`` layers,
    where JAX's ``layer_pattern`` raises; no JAX tree for it."""
    for arch_cfg, jax_cfg in ((registry.get, jax_registry.get),
                              (registry.get_smoke, jax_registry.get_smoke)):
        cfg, cfg_j = arch_cfg(ARCH), jax_cfg(ARCH)
        period = len(jax_transformer.layer_pattern(cfg_j))
        if layers >= period:
            continue
        cut = dataclasses.replace(cfg, num_layers=layers)
        assert transformer.layer_pattern(cut) == \
            jax_transformer.layer_pattern(cfg_j)[:layers]
        assert transformer.layer_plan(cut) == \
            transformer.layer_pattern(cfg)[:layers]
        with pytest.raises(ValueError, match="not divisible"):
            jax_transformer.layer_pattern(dataclasses.replace(
                cfg_j, num_layers=layers))
        model = _meta_model(cut)
        with pytest.raises(ValueError, match="no JAX parameter layout"):
            jax_tree(dict(model.named_parameters()), cut)


@pytest.mark.parametrize("smoke,layers", [(False, 10), (False, 12),
                                          (False, 20), (True, 6),
                                          (True, 10)])
def test_a_non_multiple_above_one_period_raises_in_both(smoke, layers):
    get, get_j = ((registry.get_smoke, jax_registry.get_smoke) if smoke
                  else (registry.get, jax_registry.get))
    for cfg, fn in ((get(ARCH), transformer.layer_pattern),
                    (get_j(ARCH), jax_transformer.layer_pattern)):
        with pytest.raises(ValueError, match="not divisible"):
            fn(dataclasses.replace(cfg, num_layers=layers))


# ---------------------------------------------------------------------------
# the halo exchange, the conv and the block
# ---------------------------------------------------------------------------

def _local_rt(cfg, seq=SEQ):
    plan = make_plan(cfg, ShapeConfig("t", seq, BATCH, "train"), n_devices=1)
    return dataclasses.replace(train_step.make_runtime(
        _meta_model(cfg), plan.run_config(), plan.shape_config()),
        device=torch.device("cpu"))


def _rank_rt(comm, seq=SEQ):
    return train_step.make_runtime(
        _meta_model(registry.get_smoke(ARCH)),
        RunConfig(c=comm.axis_size("sp_team")),
        ShapeConfig("t", seq, BATCH, "train"), comm)


def test_ppermute_prev_shard_and_its_transpose():
    """At P = 8 (ThreadMesh(2, 2)) rank p receives rank p - 1's tensor in
    the linear order of ``sp_rank`` (zeros on rank 0), and the gradient
    of rank p's input is rank p + 1's upstream gradient (zeros on the last
    rank); at one rank it returns zeros."""
    x = torch.ones(2, 3)
    assert torch.equal(_rank_rt(SingleComm()).ppermute_prev_shard(x),
                       torch.zeros(2, 3))

    def rank_fn(comm):
        rt = _rank_rt(comm)
        p = rt.sp_rank()
        x = torch.full((2, 3), float(p + 1), requires_grad=True)
        y = rt.ppermute_prev_shard(x)
        (y * (10.0 * (p + 1))).sum().backward()
        return p, y.detach(), x.grad

    out = ThreadMesh(2, 2).run(rank_fn)
    assert sorted(p for p, _, _ in out) == list(range(8))
    for p, y, g in out:
        assert torch.equal(y, torch.full((2, 3), float(p)))
        assert torch.equal(g, torch.full((2, 3), 10.0 * (p + 2)
                                         if p < 7 else 0.0))


def test_causal_conv_matches_jax_and_its_halo_the_one_rank_conv():
    """Local mode against JAX's (zeros before the sequence); over 8 ranks
    the halo makes the slices' convs the one-rank conv of the whole
    sequence, and each rank's input gradient its slice of the one-rank
    gradient."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(BATCH, SEQ, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    up = rng.normal(size=(BATCH, SEQ, 12)).astype(np.float32)
    rt_j = _jax_local_rt(_ctx()["model_j"])
    want = jax_ssm._causal_conv(rt_j, jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    got = ssm._causal_conv(_rank_rt(SingleComm()), xt, torch.from_numpy(w))
    _assert_scaled(got.detach().numpy(), want, "conv")
    (got * torch.from_numpy(up)).sum().backward()
    n = SEQ // 8

    def rank_fn(comm):
        rt = _rank_rt(comm)
        p = rt.sp_rank()
        xs = torch.from_numpy(x[:, p * n:(p + 1) * n]).requires_grad_()
        y = ssm._causal_conv(rt, xs, torch.from_numpy(w))
        (y * torch.from_numpy(up[:, p * n:(p + 1) * n])).sum().backward()
        return p, y.detach(), xs.grad

    out = sorted(ThreadMesh(2, 2).run(rank_fn), key=lambda t: t[0])
    joined = torch.cat([y for _, y, _ in out], dim=1)
    np.testing.assert_allclose(joined.numpy(), got.detach().numpy(),
                               atol=1e-6, rtol=1e-6)
    grads = torch.cat([g for _, _, g in out], dim=1)
    np.testing.assert_allclose(grads.numpy(), xt.grad.numpy(), atol=1e-6,
                               rtol=1e-6)


def _mamba_params(layer=0):
    """Layer ``layer``'s Mamba mixer in both packages (JAX's from the
    stacked tree: smoke layer 0 is sub0 of period 0)."""
    ctx = _ctx()
    model = from_jax_params(ctx["tree"], ctx["cfg"], "cpu")
    n_sub = len(jax_transformer.layer_pattern(ctx["cfg_j"]))
    p_j = jax.tree.map(lambda a: a[layer // n_sub],
                       ctx["tree"]["stack"][f"sub{layer % n_sub}"]["mixer"])
    return model.layers[layer].mixer, p_j


def _jax_raw_conv_input(p_j, x, cfg_j):
    """The conv's raw input, the in_proj slice JAX's block convolves."""
    di = cfg_j.mamba.expand * cfg_j.d_model
    h = jax_blocks.rmsnorm(p_j["norm_in"], jnp.asarray(x), cfg_j.norm_eps)
    return np.asarray(jnp.einsum("bsd,dx->bsx", h, p_j["in_proj"])[..., :di])


def test_mamba_block_matches_jax_local_mode():
    """The block's output and returned SSM state against JAX's in local
    mode; the returned conv state is the last d_conv - 1 raw inputs."""
    ctx = _ctx()
    cfg, cfg_j = ctx["cfg"], ctx["cfg_j"]
    p, p_j = _mamba_params()
    x = np.random.default_rng(5).normal(
        size=(BATCH, SEQ, cfg.d_model)).astype(np.float32)
    y_j, st_j = jax_ssm.mamba_block(_jax_local_rt(ctx["model_j"]), p_j,
                                    jnp.asarray(x), cfg_j, return_state=True)
    with torch.no_grad():
        y, st = ssm.mamba_block(_local_rt(cfg), p, torch.from_numpy(x), cfg,
                                return_state=True)
    _assert_scaled(y.numpy(), y_j, "out")
    assert sorted(st) == sorted(st_j) == ["conv", "state"]
    _assert_scaled(st["state"].numpy(), st_j["state"], "state")
    _assert_scaled(st["conv"].numpy(),
                   _jax_raw_conv_input(p_j, x, cfg_j)[:, -3:], "conv")


def test_jax_prefill_caches_the_silud_conv_output():
    """The reference fault, pinned: JAX's ``lm_prefill`` stores the conv's
    SiLU'd output of the last d_conv - 1 positions as layer 0's conv
    state (``repro/models/ssm.py:194, :217``), not the raw inputs its
    decode step expects (``repro/serve/step.py:131-134``); the port's
    prefill stores the raw inputs."""
    ctx = _ctx()
    cfg, cfg_j = ctx["cfg"], ctx["cfg_j"]
    p, p_j = _mamba_params()
    params = jax.tree.map(jnp.asarray, ctx["tree"])
    tokens = ctx["batch"]["tokens"]
    rt_j = _jax_local_rt(ctx["model_j"], kind="prefill")
    _, cache_j = jax_serve_step.lm_prefill(rt_j, params, {"tokens": tokens},
                                           cfg_j)
    conv_j = np.asarray(cache_j["stack"]["sub0"]["conv"][0])
    x0 = np.asarray(jax_blocks.embed(rt_j, params["embed"], tokens, cfg_j))
    raw = _jax_raw_conv_input(p_j, x0, cfg_j)
    silud = np.asarray(jax.nn.silu(jax_ssm._causal_conv(
        rt_j, jnp.asarray(raw), p_j["conv_w"])))
    _assert_scaled(conv_j, silud[:, -3:], "JAX caches the SiLU'd output")
    assert np.abs(conv_j - raw[:, -3:]).max() > 1e-2 * np.abs(raw).max()
    model = from_jax_params(ctx["tree"], cfg, "cpu")
    with torch.no_grad():
        _, cache = serve_step.lm_prefill(
            _local_rt(cfg), model, torch.from_numpy(tokens.astype(np.int64)),
            cfg)
    _assert_scaled(cache[0]["conv"].numpy(), raw[:, -3:], "port")


def _full_argmax(model, tokens):
    """The port's full-forward (training path) argmax at every position of
    ``tokens`` (B, S) at P = 1, right-padded to a multiple of the Mamba
    chunk (causality keeps the padding invisible before it)."""
    cfg = model.cfg
    S = tokens.shape[1]
    padded = torch.nn.functional.pad(tokens, (0, -S % cfg.mamba.chunk))
    rt = _local_rt(cfg, padded.shape[1])
    with torch.no_grad():
        x = blocks.embed(rt, model.embed, padded, cfg)
        x, _ = transformer.apply_stack(rt, model.layers, x, cfg,
                                       remat="none")
        x = blocks.rmsnorm(model.final_norm, x, cfg.norm_eps)
        logits = torch.stack([sampling.shard_logits(
            rt, model.head, x[:, s:s + 1], cfg)[0] for s in range(S)], 1)
    return logits.argmax(-1)


def test_prefill_then_decode_matches_full_forward_where_jax_does_not():
    """``test_serving_consistency`` on jamba (its config, capacity lifted
    to the expert count; its seeds; S = 17): JAX's decode token leaves the
    full-forward argmax (the failing reference test), the port's prefill
    then one decode step give it, and the port's full forward equals
    JAX's."""
    from test_serving_consistency import (_consistency_cfg, _full_logits,
                                          _pad_attn_cache, _rt)

    S = CONSISTENCY_S
    cfg_j = _consistency_cfg(ARCH)
    model_j = jax_build_model(cfg_j)
    params = model_j.init(jax.random.PRNGKey(0))
    s_ref = ((S + 7) // 8) * 8
    tokens = jax.random.randint(jax.random.PRNGKey(1), (1, s_ref), 0,
                                cfg_j.vocab_size, jnp.int32)
    ref = np.asarray(_full_logits(model_j, params, tokens)).argmax(-1)[0]
    rt_j = _rt(cfg_j, S - 1)
    tok_p, cache_j = jax_serve_step.lm_prefill(
        rt_j, params, {"tokens": tokens[:, :S - 1]}, cfg_j)
    assert int(np.asarray(tok_p)[0, 0]) == int(ref[S - 2])
    tok_d, _ = jax_serve_step.lm_decode_step(
        rt_j, params, _pad_attn_cache(cache_j, S), tokens[:, S - 1:S], cfg_j,
        S - 1)
    assert int(np.asarray(tok_d)[0, 0]) != int(ref[S - 1])

    cfg = registry.get_smoke(ARCH)
    cfg = dataclasses.replace(cfg, moe=cfg_j.moe)
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg, "cpu")
    toks = torch.from_numpy(np.asarray(tokens).astype(np.int64))
    np.testing.assert_array_equal(_full_argmax(model, toks).numpy()[0], ref)
    rt = _local_rt(cfg, S - 1)
    with torch.no_grad():
        tok, cache_p = serve_step.lm_prefill(rt, model, toks[:, :S - 1], cfg)
        assert int(tok[0, 0]) == int(ref[S - 2])
        cache = kv_cache.init_cache(cfg, 1, S, "cpu")
        kv_cache.fill_from_prefill(cfg, [cache], [cache_p], S - 1)
        tok = serve_step.lm_decode_step(
            _local_rt(cfg, S), model, cache, toks[:, S - 1:S], cfg,
            torch.full((1,), S - 1, dtype=torch.int32))
    assert int(tok[0, 0]) == int(ref[S - 1])


def test_mamba_decode_matches_jax_given_the_same_cache():
    """One token through layer 0 from the same random (conv, state) cache:
    output and both updated states against JAX's ``_mamba_decode``."""
    ctx = _ctx()
    cfg, cfg_j = ctx["cfg"], ctx["cfg_j"]
    p, p_j = _mamba_params()
    m = cfg.mamba
    di = m.expand * cfg.d_model
    rng = np.random.default_rng(8)
    x = rng.normal(size=(BATCH, 1, cfg.d_model)).astype(np.float32)
    conv = rng.normal(size=(BATCH, m.d_conv - 1, di)).astype(np.float32)
    state = rng.normal(size=(BATCH, di // m.head_dim, m.d_state,
                             m.head_dim)).astype(np.float32)
    y_j, cache_j = jax_serve_step._mamba_decode(
        _jax_local_rt(ctx["model_j"], kind="decode"), p_j, jnp.asarray(x),
        {"conv": jnp.asarray(conv), "state": jnp.asarray(state)}, cfg_j)
    cache = {"conv": torch.from_numpy(conv.copy()),
             "state": torch.from_numpy(state.copy())}
    with torch.no_grad():
        y = serve_step._mamba_decode(_local_rt(cfg), p, torch.from_numpy(x),
                                     cache, cfg)
    _assert_scaled(y.numpy(), y_j, "out")
    for n in ("conv", "state"):
        _assert_scaled(cache[n].numpy(), cache_j[n], n)


# ---------------------------------------------------------------------------
# refusals, launchers and checkpoints (before the tests that wait for the
# JAX child process)
# ---------------------------------------------------------------------------

def test_engine_gateway_and_launcher_refuse_hybrid():
    """The Mamba layers' per-slot states have no paged layout: the JAX
    engine's reason, from the engine, the gateway and ``launch.serve``
    without ``--legacy``."""
    from repro_torch.gateway import build_gateway

    ok, why = jax_paged_cache.supported(jax_registry.get_smoke(ARCH))
    assert not ok and "'mamba'" in why
    eng = torch_engine.EngineConfig(max_slots=1, page_size=4,
                                    pages_per_shard=8, max_len=32)
    with pytest.raises(NotImplementedError) as e:
        torch_engine.build_engine(ARCH, smoke=True, c=1, data=1,
                                  device="cpu", eng=eng)
    assert str(e.value).endswith(why)
    with pytest.raises(NotImplementedError) as e:
        build_gateway(ARCH, smoke=True, c=1, data=1, replicas=1,
                      prefix_cache=True, device="cpu", eng=eng)
    assert str(e.value).endswith(why)
    with pytest.raises(NotImplementedError) as e:
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--requests", "2"])
    assert str(e.value).endswith(why)


def test_launch_serve_legacy_on_four_ranks(capsys):
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--legacy", "--devices", "4", "--c", "2",
                      "--batch", "2", "--prompt-len", "16", "--gen", "3"])
    assert tuple(out.shape) == (2, 3)
    assert ((out >= 0) & (out < registry.get_smoke(ARCH).vocab_size)).all()
    assert "P_sp=4" in capsys.readouterr().out


def test_launch_train_hybrid_on_eight_ranks(tmp_path, capsys):
    """Each step a fresh synthetic batch: finite losses, every step taken,
    on the plan's mesh."""
    from repro_torch.launch import train

    metrics = tmp_path / "m.jsonl"
    out = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--devices", "8", "--data", "2", "--c", "2",
                      "--steps", "3", "--metrics", str(metrics)])
    losses = [json.loads(x)["loss"] for x in metrics.read_text().splitlines()]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert out["step"] == 3
    text = capsys.readouterr().out
    assert "P_sp=4" in text and "data=2" in text


def test_checkpoint_round_trips_in_the_jax_format(tmp_path):
    """The port's hybrid tree saved and restored by the JAX package (its
    flatten order of the period's sub-layers), then back into a port
    model."""
    from repro.dist import checkpoint as jax_ckpt

    ctx = _ctx()
    cfg = ctx["cfg"]
    model = build_model(cfg, "cpu", seed=4)
    tree = jax_tree(dict(model.named_parameters()), cfg)
    checkpoint.save(tmp_path, 3, tree)
    got = jax_ckpt.restore(tmp_path, 3, ctx["tree"])
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(got)]
    assert paths == [jax.tree_util.keystr(p) for p, _ in
                     jax.tree_util.tree_leaves_with_path(ctx["tree"])]
    for a, b in zip(jax.tree.leaves(got), checkpoint.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jax_ckpt.save(tmp_path / "j", 4, got)
    back = build_model(cfg, "cpu", seed=5)
    load_jax_tree(back, checkpoint.restore(tmp_path / "j", 4, tree))
    for (n, a), b in zip(model.named_parameters(), back.parameters()):
        assert torch.equal(a, b), n


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def _leaf_errs(model, grads, want):
    """{JAX path: max |port - JAX|} of every gradient leaf, ``want`` a
    function of the JAX path."""
    names = [n for n, _ in model.named_parameters()]
    got = to_jax_layout(dict(zip(names, grads)), model.cfg)
    return {jax.tree_util.keystr(p): float(np.max(np.abs(
        g - want(jax.tree_util.keystr(p)))))
        for p, g in jax.tree_util.tree_leaves_with_path(got)}


def _lifted_model():
    ctx = _ctx()
    return from_jax_params(ctx["tree"], _lifted(ctx["cfg"]), "cpu")


def test_loss_and_grads_match_jax_local_mode():
    ctx = _ctx()
    model_j = ctx["lifted_j"]
    rt_j = jax_train_step.make_runtime(
        model_j, JaxRunConfig(c=1), JaxShapeConfig("test", SEQ, BATCH,
                                                   "train"), mode="local")
    loss_j, grads_j = jax.jit(jax.value_and_grad(lambda p: model_j.loss(
        rt_j, p, ctx["batch"], remat="none")))(ctx["tree"])
    flat = {jax.tree_util.keystr(p): np.asarray(g) for p, g in
            jax.tree_util.tree_leaves_with_path(grads_j)}
    model = _lifted_model()
    batch = {k: torch.from_numpy(v) for k, v in ctx["batch"].items()}
    for remat in ("none", "attn_out", "full"):
        vg, _ = train_step.build_value_and_grad_fn(
            model, RunConfig(c=1, remat=remat),
            ShapeConfig("test", SEQ, BATCH, "train"))
        loss, grads = vg(batch)
        assert abs(float(loss) - float(loss_j)) < TOL, remat
        errs = _leaf_errs(model, grads, flat.get)
        assert len(errs) == len(flat) and max(errs.values()) < TOL, errs
        assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("rules", RULE_SETS)
@pytest.mark.parametrize("c,r,data", MESHES,
                         ids=["c2r1d2", "c1r4d2", "c2r2d1"])
def test_loss_and_grads_match_the_jax_island(references, c, r, data, rules):
    want = references()
    ctx = _ctx()
    model = _lifted_model()
    losses, grads = mesh_whole_grads(
        model, ThreadMesh(c, r, data),
        RunConfig(c=c, seq_scheme="zigzag", sharding_rules=rules),
        ShapeConfig("test", SEQ, BATCH, "train"),
        {k: torch.from_numpy(v) for k, v in ctx["batch"].items()})
    key = f"{_key(c, r, data)}|{rules}"
    for loss in losses:
        assert abs(float(loss) - float(want[f"{key}|loss"])) < TOL
    errs = _leaf_errs(model, grads, lambda p: want[f"{key}|{p}"])
    assert len(errs) == len(jax.tree.leaves(ctx["tree"]))
    assert max(errs.values()) < TOL, errs
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def choice_key(sel) -> str:
    """One rank's (T, k) expert choices of one MoE call, as a string."""
    sel = np.asarray(sel, np.int32)
    return f"{sel.shape}:{sel.tobytes().hex()}"


def _jax_step_tree(want, i):
    """The parameters JAX's step ``i`` starts from, as a JAX-layout tree
    of tensors."""
    return jax.tree_util.tree_map_with_path(
        lambda path, _: torch.from_numpy(
            want[f"steps|{i}|{jax.tree_util.keystr(path)}"]),
        _ctx()["tree"])


def test_three_mesh_train_steps_match_jax(references, monkeypatch):
    """Three ``plan.build_train_step`` steps at (2, 1, 2) against JAX
    ``build_train_step``, each from the parameters JAX's step starts from:
    loss and grad norm within ``TOL``, every rank's expert choices equal to
    JAX's. (Run free, the port's parameters drift from JAX's at step 0:
    AdamW's first update ``g / (|g| + eps)`` gives the thousands of
    elements whose gradient is below 1e-6, f32 noise, a near-full ``lr``
    step of either sign, 2.7e-4 apart after one step; the step-2 grad
    norm then lay 2.7e-3 from JAX's.)"""
    want = references()
    ctx = _ctx()
    model = _lifted_model()
    plan = make_plan(model.cfg, ShapeConfig("test", SEQ, BATCH, "train"),
                     n_devices=8, data=2, c=2)
    assert (plan.c, plan.r, plan.data) == ISLAND
    assert plan.run_config().seq_scheme == "contiguous"
    step, sh = plan.build_train_step(model, adamw.AdamWConfig(**ADAM_STEP))
    opt = adamw.init_state(sh["params"], adamw.AdamWConfig(**ADAM_STEP))
    batch = {k: torch.from_numpy(v) for k, v in ctx["batch"].items()}
    seen = set()
    route = moe.route

    def recording_route(probs, k):
        gates, sel = route(probs, k)
        seen.add(choice_key(sel))
        return gates, sel

    monkeypatch.setattr(moe, "route", recording_route)
    losses = []
    for i, (loss_j, gnorm_j) in enumerate(want["steps"]):
        load_jax_tree(model, _jax_step_tree(want, i))
        seen.clear()
        opt, m = step(opt, batch)
        assert abs(float(m["loss"]) - loss_j) < TOL, (i, "loss")
        assert abs(float(m["grad_norm"]) - gnorm_j) < TOL, (i, "grad_norm")
        assert seen and sorted(seen) == list(want[f"steps|{i}|choices"]), i
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_runtime_forces_the_contiguous_layout():
    """A zigzag run config lays a hybrid stack's sequence out contiguously
    (the conv halo and the state correction need it), as JAX's does."""
    rt = train_step.make_runtime(
        _meta_model(registry.get_smoke(ARCH)),
        RunConfig(c=1, seq_scheme="zigzag"),
        ShapeConfig("t", SEQ, BATCH, "train"))
    assert rt.st_cfg.seq_scheme == "contiguous"


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _jax_cache_leaf(want, where, i, n):
    """Layer ``i``'s leaf ``n`` of the JAX prefill cache (period-stacked
    over the smoke period of 4)."""
    return want[f"prefill|{where}|['stack']['sub{i % 4}']['{n}']"][i // 4]


def test_prefill_caches_match_jax(references):
    """The attention layer's K/V and each Mamba layer's SSM state, at
    P = 1 and on every rank of the (2, 1, 2) mesh (its rows, and its
    positions of the K/V), against the JAX ``lm_prefill`` cache; the first
    tokens too. (The conv states are held in
    ``test_jax_prefill_caches_the_silud_conv_output``.)"""
    want = references()
    ctx = _ctx()
    cfg = ctx["cfg"]
    model = from_jax_params(ctx["tree"], cfg, "cpu")
    tokens = torch.from_numpy(ctx["batch"]["tokens"].astype(np.int64))
    shape = ShapeConfig("t", SEQ, BATCH, "prefill")
    run_cfg = RunConfig(c=1, seq_scheme="contiguous")
    tok, caches = serve_step.build_prefill_step(model, run_cfg, shape)(tokens)
    np.testing.assert_array_equal(tok.numpy(), want["prefill|1|tok"])
    assert len(caches) == 1 and len(caches[0]) == cfg.num_layers
    for i, layer in enumerate(caches[0]):
        for n, t in layer.items():
            if n != "conv":
                _assert_scaled(t.numpy(), _jax_cache_leaf(want, 1, i, n),
                               (i, n))
    c, r, data = ISLAND
    fn = serve_step.build_prefill_step(model, RunConfig(
        c=c, seq_scheme="contiguous"), shape, ThreadMesh(c, r, data))
    tok, caches = fn(tokens)
    where = _key(*ISLAND)
    np.testing.assert_array_equal(tok.numpy(), want[f"prefill|{where}|tok"])
    rows = BATCH // data
    s_loc = SEQ // (c * c * r)
    for rank, (d, sp) in enumerate(fn.steps.where):
        for i, layer in enumerate(caches[rank]):
            for n, t in layer.items():
                if n == "conv":
                    continue
                leaf = _jax_cache_leaf(want, where, i, n)[
                    d * rows:(d + 1) * rows]
                if n in ("k", "v"):
                    leaf = leaf[:, sp * s_loc:(sp + 1) * s_loc]
                _assert_scaled(t.numpy(), leaf, (rank, i, n))


def test_decode_step_at_c2_data2_gives_serve_hybrids_tokens(references):
    """``serve_hybrid``: one decode step from a zero cache at (c, r, data)
    = (2, 1, 2), the batch split over the replicas, against the JAX spmd
    and local-mode steps; the Mamba states advance in place on every
    rank."""
    want = references()
    np.testing.assert_array_equal(want["serve|spmd"], want["serve|local"])
    ctx = _ctx()
    cfg = ctx["cfg"]
    model = from_jax_params(ctx["tree"], cfg, "cpu")
    c, r, data = SERVE_MESH
    fn = serve_step.build_decode_step(
        model, RunConfig(c=c, seq_scheme="contiguous"),
        ShapeConfig("t", SEQ, 2, "decode"), ThreadMesh(c, r, data))
    assert fn.steps.split and fn.steps.rows == 1
    caches = [kv_cache.init_cache(cfg, 1, SEQ // (c * c * r), "cpu")
              for _ in fn.steps.where]
    toks = torch.from_numpy(_serve_tokens(cfg.vocab_size).astype(np.int64))
    got = fn(caches, toks, torch.full((2,), SEQ - 1, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), want["serve|spmd"])
    for cache in caches:
        assert float(cache[0]["state"].abs().max()) > 0
        assert float(cache[0]["conv"][:, -1].abs().max()) > 0


@pytest.mark.parametrize("n_devices", LEGACY_SP)
def test_legacy_first_token_is_jaxs_and_the_rest_the_full_forward(
        references, n_devices):
    """``legacy_generate`` at P = 1 and P = 4 (c = 2, r = 1), capacity
    lifted: the first token is the JAX prefill island's; every later
    token is the port's full-forward argmax over the generated sequence
    (JAX's decode steps are no oracle here, see
    ``test_jax_prefill_caches_the_silud_conv_output``)."""
    want = references()[f"legacy|{n_devices}"]
    model = _lifted_model()
    cfg = model.cfg
    plan = make_serve_plan(cfg, arch=ARCH, n_devices=n_devices,
                           c=2 if n_devices > 1 else 1)
    assert plan.sp_size == n_devices
    tokens = torch.from_numpy(_legacy_tokens(cfg.vocab_size))
    got = serve.legacy_generate(model, plan, tokens, LEGACY["gen"])
    assert got.shape == (LEGACY["batch"], LEGACY["gen"])
    np.testing.assert_array_equal(got[:, :1].numpy(), want)
    seq = torch.cat([tokens, got[:, :-1]], dim=1)
    full = _full_argmax(model, seq)[:, LEGACY["prompt"] - 1:]
    np.testing.assert_array_equal(got.numpy(), full.numpy())
