"""repro_torch's MoE family (``models/moe.py``) against the JAX package.

Smoke phi3.5-moe-42b-a6.6b (4 experts, top-2, MoE on every layer) and smoke
llama4-maverick-400b-a17b (4 experts, top-1, a shared expert, a dense
layer then a MoE layer), f32, with the JAX parameters carried across by
``from_jax_params`` and the same numpy batch.

* Both configs and their smoke configs equal JAX's field for field;
  ``moe_on_layer`` and ``layer_pattern`` match; the VLM raises, but
  jamba and seamless-m4t (ported since) give JAX's configs.
* ``moe_block`` at the default capacity (tokens dropped) against JAX's
  ``moe_block`` in local mode: the output within 2e-5 of its largest
  magnitude (the blocks' outputs reach ~3e3 at the smoke init, where f32
  rounding alone is ~3e-7 of it in either package), each aux loss within
  1e-6; an exact top-k tie picks the lower expert, as ``jax.lax.top_k``.
* Loss and every gradient leaf within 2e-3 (``spmd_moe``'s bound): against
  the JAX local mode with capacity lifted to 8.0 at P = 1 and on
  ``ThreadMesh`` (c, r, data) = (2, 1, 2), (1, 4, 2) and (2, 2, 1); and
  against the JAX spmd island at (2, 1, 2) at the default capacity 1.25
  under ``default``, ``fsdp`` and ``tp``. Three train steps at (2, 1, 2)
  against JAX ``build_train_step`` (lr 1e-2, ``check_spmd_train_step``):
  the losses within 2e-3, and they fall.
* The JAX references that need a mesh (the islands, the train steps, the
  JAX engines) run in one child process with 8 forced host devices,
  started by the first test so it overlaps the rest.
* Serving: one decode step at (c, data) = (2, 2) gives the JAX local-mode
  tokens (``serve_moe``); ``engine_moe``'s three requests give the JAX
  engine's streams token for token at the layouts JAX's ``build_engine``
  picks on 4 devices, (c, r, data) = (1, 4, 1), (2, 1, 1) and (1, 2, 2),
  and replay equal after ``reset()``; a prompt of 13 tokens gives the JAX
  stream only when padded to the JAX bucket (16), not at its own length;
  ``--legacy`` gives the JAX static-batch steps' tokens at P = 1.
* Chunked prefill and prefix caching are refused for MoE stacks, as in
  JAX; the launchers train and serve both smoke configs.
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
from repro.models import moe as jax_moe
from repro.models import transformer as jax_transformer
from repro.models.factory import build_model as jax_build_model
from repro.plan import make_serve_plan as jax_make_serve_plan
from repro.serve import step as jax_serve_step
from repro.train import step as jax_train_step
from repro_torch import engine as torch_engine
from repro_torch.configs import registry
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.data import pipeline
from repro_torch.dist.comm import ThreadMesh
from repro_torch.engine import paged_cache
from repro_torch.launch import serve
from repro_torch.models import moe, transformer
from repro_torch.models.factory import (from_jax_params, shard_params,
                                        to_jax_layout)
from repro_torch.optim import adamw
from repro_torch.plan import make_plan, make_serve_plan
from repro_torch.serve import step as serve_step
from repro_torch.train import step as train_step
from test_torch_legacy import _jax_legacy_steps
from test_torch_train_sp import _sharded, mesh_whole_grads

ARCHS = ["phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b"]
PHI, LLAMA = ARCHS
SEQ, BATCH = 32, 2
TOL = 2e-3
RULE_SETS = ["default", "fsdp", "tp"]
ISLAND = (2, 1, 2)                       # (c, r, data) of the JAX islands
LOCAL_LAYOUTS = [(2, 1, 2), (1, 4, 2), (2, 2, 1)]
# the (c, r, data) JAX's build_engine picks on 4 devices for its (c, data)
ENGINE_LAYOUTS = [(1, 4, 1), (2, 1, 1), (1, 2, 2)]
ENG = dict(max_slots=2, page_size=4, pages_per_shard=16, max_len=64)
# prompt lengths whose capacity cut moves with the padding (the bucket is
# 64 for both)
PAD_PROMPT, PAD_GEN = {PHI: 37, LLAMA: 41}, 8
# lr 1e-3 as the port's other step tests: at 1e-2 Adam's first step turns
# f32 noise on near-zero gradient entries into +-lr updates (at capacity 8.0
# too), and the grad norms part by ~1e-3 of themselves by the third step
ADAM_STEP = dict(learning_rate=1e-3, warmup_steps=0)
_CTX = {}


def _lifted(cfg, factor=8.0):
    """``cfg`` with the capacity factor lifted (no token dropped)."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor))


def _ctx(arch):
    if arch not in _CTX:
        cfg_j = jax_registry.get_smoke(arch)
        model_j = jax_build_model(cfg_j)
        tree = jax.tree.map(np.asarray, model_j.init(jax.random.PRNGKey(0)))
        rng = np.random.default_rng(0)
        batch = {n: rng.integers(0, cfg_j.vocab_size, (BATCH, SEQ),
                                 dtype=np.int32)
                 for n in ("tokens", "labels")}
        _CTX[arch] = dict(cfg_j=cfg_j, model_j=model_j, tree=tree,
                          batch=batch, cfg=registry.get_smoke(arch))
    return _CTX[arch]


def _engine_requests(vocab, cls):
    """``check_engine_moe``'s three requests."""
    rng = np.random.default_rng(2)
    return [cls(f"m{i}", rng.integers(0, vocab, 5 + 3 * i).tolist(), 3 + i)
            for i in range(3)]


def _pad_prompt(arch, vocab):
    return np.random.default_rng(4).integers(0, vocab,
                                             PAD_PROMPT[arch]).tolist()


def _layout_key(c, r, data):
    return f"{c}{r}{data}"


# ---------------------------------------------------------------------------
# the JAX references on a mesh, in one child process with 8 host devices
# ---------------------------------------------------------------------------

def jax_references():
    """Everything the port is held against that needs a JAX mesh, as a
    flat dict of numpy arrays (run in the child process)."""
    from repro import engine as jax_engine
    from repro.data import pipeline as jax_pipeline
    from repro.dist import meshes
    from repro.optim import adamw as jax_adamw

    out = {}
    c, r, data = ISLAND
    mesh = meshes.local_mesh_for_tests(c=c, r=r, data=data)
    shape = JaxShapeConfig("test", seq_len=SEQ, global_batch=BATCH,
                           kind="train")
    for arch in ARCHS:
        ctx = _ctx(arch)
        model, cfg = ctx["model_j"], ctx["cfg_j"]
        params = jax.tree.map(jnp.asarray, ctx["tree"])
        batch = {k: v.numpy() for k, v in
                 _sharded(ctx["batch"], c * c * r).items()}
        for rules in RULE_SETS:
            fn, _ = jax_train_step.build_value_and_grad_fn(
                model, mesh, JaxRunConfig(c=c, seq_scheme="zigzag",
                                          sharding_rules=rules), shape)
            loss, grads = jax.jit(fn)(params, batch)
            out[f"{arch}|{rules}|loss"] = np.asarray(loss, np.float32)
            for path, g in jax.tree_util.tree_leaves_with_path(grads):
                out[f"{arch}|{rules}|{jax.tree_util.keystr(path)}"] = \
                    np.asarray(g, np.float32)
        jstep, _ = jax_train_step.build_train_step(
            model, mesh, JaxRunConfig(c=c, seq_scheme="zigzag"), shape,
            jax_adamw.AdamWConfig(**ADAM_STEP))
        # the step donates its inputs: give it copies
        p = jax.tree.map(jnp.array, ctx["tree"])
        opt = jax_adamw.init_state(p, jax_adamw.AdamWConfig(**ADAM_STEP))
        data_j = jax_pipeline.SyntheticLM(cfg, shape, seed=3,
                                          sp_size=c * c * r)
        metrics = []
        for _ in range(3):          # one batch, as check_spmd_train_step
            p, opt, m = jstep(p, opt, data_j.get_batch(0))
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
        out[f"{arch}|steps"] = np.asarray(metrics)
        for lc, lr_, ld in ENGINE_LAYOUTS + [(1, 1, 1)]:
            plan = jax_make_serve_plan(
                cfg, arch=arch, n_devices=ld * lc * lc * lr_, data=ld, c=lc,
                decode_batch=ENG["max_slots"], page_size=ENG["page_size"],
                max_len=ENG["max_len"], mesh_kind="local")
            assert (plan.c, plan.r, plan.data) == (lc, lr_, ld)
            eng = jax_engine.build_engine(
                arch, smoke=True, eng=jax_engine.EngineConfig(**ENG),
                plan=plan, params=params)
            key = f"{arch}|engine|{_layout_key(lc, lr_, ld)}"
            if (lc, lr_, ld) == (1, 1, 1):
                eng.add_request(jax_engine.Request(
                    "pad", _pad_prompt(arch, cfg.vocab_size), PAD_GEN))
                out[key] = np.asarray(eng.run()["pad"])
                continue
            for req in _engine_requests(cfg.vocab_size, jax_engine.Request):
                eng.add_request(req)
            for uid, toks in eng.run().items():
                out[f"{key}|{uid}"] = np.asarray(toks)
    return out


_JAX_CHILD = r"""
import sys
import numpy as np
sys.path.insert(0, "tests")
from test_torch_moe import jax_references
np.savez(sys.argv[1], **jax_references())
"""


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = tmp_path_factory.mktemp("moe") / "references.npz"
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
# configs and the layer pattern
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_jax(references, arch):
    """Field for field, full and smoke (this test also starts the JAX
    child process); the period and the MoE layers are JAX's."""
    for cfg, cfg_j in ((registry.get(arch), jax_registry.get(arch)),
                       (registry.get_smoke(arch),
                        jax_registry.get_smoke(arch))):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
        assert cfg.family == "moe"
        assert [cfg.moe_on_layer(i) for i in range(cfg.num_layers)] == \
            [cfg_j.moe_on_layer(i) for i in range(cfg.num_layers)]
        assert transformer.layer_pattern(cfg) == \
            jax_transformer.layer_pattern(cfg_j)
    assert registry.get(LLAMA).opt_dtype == "bfloat16"
    assert transformer.layer_pattern(registry.get(LLAMA)) == [
        ("attn", "mlp"), ("attn", "moe")]
    for other in ("paligemma-3b", "seamless-m4t-large-v2",
                  "jamba-1.5-large-398b"):
        if other == "jamba-1.5-large-398b":
            # the hybrid family is ported (§A8 c), its MoE layers JAX's
            got = registry.get_smoke(other)
            assert dataclasses.asdict(got) == dataclasses.asdict(
                jax_registry.get_smoke(other))
            assert transformer.has_moe(got)
            continue
        # the encoder-decoder (§A8 d) and VLM (§A8 e) families are
        # ported, with no MoE
        got = registry.get_smoke(other)
        assert dataclasses.asdict(got) == dataclasses.asdict(
            jax_registry.get_smoke(other))
        assert not transformer.has_moe(got)


def test_capacity_and_specs_equal_jax():
    for arch in ARCHS:
        cfg, cfg_j = registry.get(arch), jax_registry.get(arch)
        for tokens in (1, 2, 7, 64, 1000, 4096):
            assert moe._capacity(tokens, cfg.moe) == \
                jax_moe._capacity(tokens, cfg_j.moe)
        specs, specs_j = moe.moe_specs(cfg), jax_moe.moe_specs(cfg_j)
        assert sorted(specs) == sorted(specs_j)
        for name in ("router", "w1", "w3", "w2"):
            a, b = specs[name], specs_j[name]
            assert (a.shape, a.axes, a.init, a.scale) == \
                (b.shape, b.axes, b.init, b.scale), name


# ---------------------------------------------------------------------------
# the block against JAX's in local mode
# ---------------------------------------------------------------------------

def _block_inputs(arch, rows=2, seq=SEQ):
    ctx = _ctx(arch)
    sub = "sub1" if arch == LLAMA else "sub0"
    p_j = jax.tree.map(lambda a: a[0], ctx["tree"]["stack"][sub]["mlp"])
    model = from_jax_params(ctx["tree"], ctx["cfg"], "cpu")
    rng = np.random.default_rng(1)
    d = ctx["cfg"].d_model
    # a component every token shares (as hidden states have one) skews the
    # routing, so the default capacity drops tokens
    x = (rng.normal(size=(rows, seq, d))
         + 0.5 * rng.normal(size=(d,))).astype(np.float32)
    return ctx, p_j, model.layers[1 if arch == LLAMA else 0].mlp, x


def _local_rt(cfg, seq=SEQ):
    plan = make_plan(cfg, ShapeConfig("t", seq, BATCH, "train"), n_devices=1)
    return train_step.make_runtime(
        from_jax_params(_ctx(cfg.name)["tree"], cfg, "cpu"),
        plan.run_config(), plan.shape_config())


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_jax_with_tokens_dropped(arch):
    ctx, p_j, p, x = _block_inputs(arch)
    cfg, cfg_j = ctx["cfg"], ctx["cfg_j"]
    rt_j = jax_train_step.make_runtime(
        ctx["model_j"], JaxRunConfig(c=1),
        JaxShapeConfig("t", SEQ, BATCH, "train"), mode="local")
    y_j, aux_j = jax_moe.moe_block(rt_j, p_j, jnp.asarray(x), cfg_j)
    y, aux = moe.moe_block(_local_rt(cfg), p, torch.from_numpy(x), cfg)
    y_j = np.asarray(y_j)
    assert np.abs(y.numpy() - y_j).max() <= 2e-5 * np.abs(y_j).max()
    for k in ("moe_lb", "moe_z"):
        assert abs(float(aux[k]) - float(aux_j[k])) < 1e-6, k
    # the default capacity drops tokens here: some (t, k) queue past it
    h = torch.nn.functional.rms_norm(torch.from_numpy(x), (cfg.d_model,),
                                     eps=cfg.norm_eps)
    probs = torch.softmax(h.reshape(-1, cfg.d_model) @ p.router, -1)
    _, sel = moe.route(probs, cfg.moe.top_k)
    cap = moe._capacity(BATCH * SEQ, cfg.moe)
    assert int((moe.queue_positions(sel, cfg.moe.num_experts) >= cap).sum()
               ) > 0


def test_route_breaks_exact_ties_to_the_lower_expert():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25],
                          [0.1, 0.4, 0.1, 0.4],
                          [0.3, 0.2, 0.3, 0.2]])
    for k in (1, 2, 3):
        gates, sel = moe.route(probs, k)
        vals_j, sel_j = jax.lax.top_k(jnp.asarray(probs.numpy()), k)
        np.testing.assert_array_equal(sel.numpy(), np.asarray(sel_j))
        np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)
    # identical rows (the engine's zero-token padding) route identically,
    # and their queue positions run in token order
    sel = moe.route(probs[[0, 0, 0]], 2)[1]
    assert sel.tolist() == [[0, 1]] * 3
    assert moe.queue_positions(sel, 4).tolist() == [[0, 0], [1, 1], [2, 2]]


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def _jax_local_value_and_grad(arch):
    ctx = _ctx(arch)
    model_j = jax_build_model(_lifted(ctx["cfg_j"]))
    rt_j = jax_train_step.make_runtime(
        model_j, JaxRunConfig(c=1, seq_scheme="zigzag"),
        JaxShapeConfig("test", SEQ, BATCH, "train"), mode="local")
    return jax.jit(jax.value_and_grad(lambda p: model_j.loss(
        rt_j, p, ctx["batch"], remat="none")))(ctx["tree"])


def _leaf_errs(cfg, model, grads, want):
    names = [n for n, _ in model.named_parameters()]
    got = to_jax_layout(dict(zip(names, grads)), cfg)
    return {jax.tree_util.keystr(p): float(np.max(np.abs(g - w)))
            for (p, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree.leaves(want))}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_local_mode(arch):
    """Capacity 8.0 (no drops): P = 1 and three ThreadMesh layouts."""
    ctx = _ctx(arch)
    cfg = _lifted(ctx["cfg"])
    loss_j, grads_j = _jax_local_value_and_grad(arch)
    model = from_jax_params(ctx["tree"], cfg, "cpu")
    shape = ShapeConfig("test", SEQ, BATCH, "train")
    vg, _ = train_step.build_value_and_grad_fn(
        model, RunConfig(c=1, seq_scheme="zigzag", remat="none"), shape)
    batch = {k: torch.from_numpy(v) for k, v in ctx["batch"].items()}
    loss, grads = vg(batch)
    assert abs(float(loss) - float(loss_j)) < TOL
    errs = _leaf_errs(cfg, model, grads, grads_j)
    assert max(errs.values()) < TOL, errs
    layouts = LOCAL_LAYOUTS if arch == PHI else LOCAL_LAYOUTS[:1]
    for c, r, data in layouts:
        losses, grads = mesh_whole_grads(
            model, ThreadMesh(c, r, data),
            RunConfig(c=c, seq_scheme="zigzag"), shape,
            _sharded(ctx["batch"], c * c * r))
        assert abs(float(losses[0]) - float(loss_j)) < TOL, (c, r, data)
        errs = _leaf_errs(cfg, model, grads, grads_j)
        assert max(errs.values()) < TOL, (c, r, data, errs)


@pytest.mark.parametrize("rules", RULE_SETS)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_jax_island(references, arch, rules):
    """At (c, r, data) = (2, 1, 2) and the default capacity 1.25, where
    each rank's capacity cut falls in its own zigzag token order."""
    want = references()
    ctx = _ctx(arch)
    c, r, data = ISLAND
    model = from_jax_params(ctx["tree"], ctx["cfg"], "cpu")
    vg = train_step.build_mesh_value_and_grad_fn(
        model, RunConfig(c=c, seq_scheme="zigzag", sharding_rules=rules),
        ShapeConfig("test", SEQ, BATCH, "train"), ThreadMesh(c, r, data),
        timeout=120)
    loss, grads = vg(_sharded(ctx["batch"], c * c * r))
    assert abs(float(loss) - float(want[f"{arch}|{rules}|loss"])) < TOL
    names = [n for n, _ in model.named_parameters()]
    got = jax.tree_util.tree_leaves_with_path(
        to_jax_layout(dict(zip(names, grads)), ctx["cfg"]))
    assert len(got) == len(jax.tree.leaves(ctx["tree"]))
    for p, g in got:
        err = float(np.max(np.abs(
            g - want[f"{arch}|{rules}|{jax.tree_util.keystr(p)}"])))
        assert err < TOL, (rules, jax.tree_util.keystr(p), err)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_mesh_train_steps_match_jax(references, arch):
    want = references()[f"{arch}|steps"]
    ctx = _ctx(arch)
    cfg = ctx["cfg"]
    model = from_jax_params(ctx["tree"], cfg, "cpu")
    plan = make_plan(cfg, ShapeConfig("test", SEQ, BATCH, "train"),
                     n_devices=8, data=2, c=2)
    assert (plan.c, plan.r, plan.data) == ISLAND
    step, sh = plan.build_train_step(model, adamw.AdamWConfig(**ADAM_STEP))
    opt = adamw.init_state(sh["params"], adamw.AdamWConfig(**ADAM_STEP))
    data_t = pipeline.SyntheticLM(cfg, plan.shape_config(), seed=3,
                                  sp_size=plan.sp_size)
    losses = []
    batch = {k: torch.from_numpy(v) for k, v in data_t.get_batch(0).items()}
    for i, (loss_j, gnorm_j) in enumerate(want):
        opt, m = step(opt, batch)
        assert abs(float(m["loss"]) - loss_j) < TOL, (i, "loss")
        assert abs(float(m["grad_norm"]) - gnorm_j) < TOL, (
            i, "grad_norm", float(m["grad_norm"]), gnorm_j)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_losses_enter_the_loss_once(arch):
    """The loss is the cross-entropy plus 0.01 lb + 1e-3 z of every MoE
    layer, summed (JAX's ``apply_stack`` weights); a dense stack's aux is
    0."""
    from repro_torch.models import blocks

    ctx = _ctx(arch)
    cfg = ctx["cfg"]
    model = from_jax_params(ctx["tree"], cfg, "cpu")
    rt = _local_rt(cfg)
    batch = {k: torch.from_numpy(v).long() for k, v in ctx["batch"].items()}
    with torch.no_grad():
        x = blocks.embed(rt, model.embed, batch["tokens"], cfg)
        want = torch.zeros(())
        for layer, kind in zip(model.layers, transformer.layer_kinds(cfg)):
            x = blocks.attention_block(rt, layer.mixer, x, cfg,
                                       window=cfg.window)
            if kind == "moe":
                x, aux = moe.moe_block(rt, layer.mlp, x, cfg)
                want = want + (0.01 * aux["moe_lb"] + 1e-3 * aux["moe_z"])
            else:
                x = blocks.mlp_block(rt, layer.mlp, x, cfg)
        ce = blocks.lm_head_logits_and_loss(
            rt, model.head, blocks.rmsnorm(model.final_norm, x, cfg.norm_eps),
            batch["labels"], cfg)
        x0 = blocks.embed(rt, model.embed, batch["tokens"], cfg)
        _, aux = transformer.apply_stack(rt, model.layers, x0, cfg)
        total = model.loss(rt, model, batch)
    assert float(aux) == float(want) > 0
    assert float(total) == float(ce + aux)
    assert transformer.layer_kinds(cfg).count("moe") == (
        2 if arch == PHI else 1)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_at_c2_data2_matches_jax_local_mode(arch):
    """``serve_moe``: one paged decode step at (c, r, data) = (2, 1, 2),
    the tokens replicated on every SP rank (each rank's MoE block gathers
    the 4 ranks' copies, as JAX's does), against the JAX local-mode decode
    step over a contiguous cache holding the same K/V."""
    ctx = _ctx(arch)
    cfg, tree = ctx["cfg"], ctx["tree"]
    B, S, ps = 2, 32, 4
    c, r, data = 2, 1, 2
    sp = c * c * r
    W = S // ps // sp                       # blocks of a row on each rank
    L, Hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
    rng = np.random.default_rng(4)
    kv = {n: rng.normal(size=(L, B, S, Hkv, hd)).astype(np.float32)
          for n in "kv"}
    tokens = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    cache_len = np.asarray([19, 30], np.int32)
    n_sub = len(transformer.layer_pattern(cfg))
    cache_j = {"stack": {f"sub{i}": {n: kv[n][i::n_sub] for n in "kv"}
                         for i in range(n_sub)}}
    rt_j = dataclasses.replace(jax_train_step.make_runtime(
        ctx["model_j"], JaxRunConfig(c=1, seq_scheme="contiguous"),
        JaxShapeConfig("t", S, B, "decode"), mode="local"), batch_axes=())
    want, _ = jax.jit(lambda p, c_, t, cl: jax_serve_step.lm_decode_step(
        rt_j, p, c_, t, ctx["cfg_j"], cl))(tree, cache_j, tokens, cache_len)

    # block g of row b lives on SP rank g % sp as its page b * W + g // sp
    pools = []
    for rank in range(sp):
        blocks = {n: np.stack([kv[n][:, b, g * ps:(g + 1) * ps]
                               for b in range(B)
                               for g in range(rank, S // ps, sp)], 1)
                  for n in "kv"}
        pools.append({n: torch.from_numpy(blocks[n]) for n in "kv"})
    table = np.broadcast_to(
        (np.arange(B, dtype=np.int32)[:, None] * W
         + np.arange(W, dtype=np.int32)[None])[:, None, :],
        (B, sp, W)).copy()
    paged = paged_cache.PagedTables(table=table, cache_len=cache_len,
                                    active=np.ones(B, bool), page_size=ps,
                                    device=torch.device("cpu"))
    model = from_jax_params(tree, cfg, "cpu")
    plan = make_serve_plan(cfg, arch=arch, n_devices=data * sp, data=data,
                           c=c, decode_batch=B, page_size=ps, max_len=S)
    rt0 = torch_engine.Engine(model, plan, torch_engine.EngineConfig(
        **{**ENG, "pages_per_shard": B * W})).rt

    def rank_fn(comm):
        rt = dataclasses.replace(rt0, comm=comm)
        own = {n: t.clone() for n, t in pools[rt.sp_rank()].items()}
        with torch.no_grad():
            return serve_step.lm_decode_step(
                rt, shard_params(model, comm, rt.rules), own,
                torch.from_numpy(tokens.astype(np.int64)), cfg,
                torch.from_numpy(cache_len), paged)

    for tok in ThreadMesh(c, r, data).run(rank_fn, timeout=120):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(want))


def _port_engine(arch, c, r, data, model=None, **eng):
    ctx = _ctx(arch)
    model = model or from_jax_params(ctx["tree"], ctx["cfg"], "cpu")
    plan = make_serve_plan(
        ctx["cfg"], arch=arch, n_devices=data * c * c * r, data=data, c=c,
        decode_batch=ENG["max_slots"], page_size=ENG["page_size"],
        max_len=ENG["max_len"], prefix_cache=eng.pop("prefix", False))
    assert (plan.c, plan.r, plan.data) == (c, r, data)
    return torch_engine.Engine(model, plan, torch_engine.EngineConfig(
        **ENG, **eng))


@pytest.mark.parametrize("c,r,data", ENGINE_LAYOUTS,
                         ids=["c1r4d1", "c2r1d1", "c1r2d2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_match_the_jax_engine(references, arch, c, r, data):
    want = references()
    vocab = _ctx(arch)["cfg"].vocab_size
    eng = _port_engine(arch, c, r, data)
    reqs = _engine_requests(vocab, torch_engine.Request)
    for req in reqs:
        assert eng.add_request(req) is None
    got = eng.run()
    key = f"{arch}|engine|{_layout_key(c, r, data)}"
    for req in reqs:
        assert got[req.uid] == want[f"{key}|{req.uid}"].tolist(), req.uid
    eng.reset()
    for req in reqs:
        eng.add_request(req)
    assert eng.run() == got


def test_phi_streams_depend_on_the_data_layout(references):
    """The JAX engine's phi streams differ between data 1 and data 2 (each
    rank's capacity is reckoned from its own tokens), so both layouts
    above hold the port to different streams."""
    want = references()
    a = f"{PHI}|engine|{_layout_key(1, 4, 1)}"
    b = f"{PHI}|engine|{_layout_key(1, 2, 2)}"
    assert any(not np.array_equal(want[f"{a}|m{i}"], want[f"{b}|m{i}"])
               for i in range(3))


def _jax_prefill_hidden(arch, tokens, length):
    """JAX's local-mode next-token hidden state of ``tokens`` zero-padded
    to ``length``."""
    ctx = _ctx(arch)
    buf = np.zeros((1, length), np.int32)
    buf[0, :len(tokens)] = tokens
    rt_j = jax_train_step.make_runtime(
        ctx["model_j"], JaxRunConfig(c=1, seq_scheme="contiguous"),
        JaxShapeConfig("t", length, 1, "prefill"), mode="local")
    hidden, _ = jax_serve_step.lm_prefill(
        rt_j, jax.tree.map(jnp.asarray, ctx["tree"]), {"tokens": buf},
        ctx["cfg_j"], prompt_len=np.asarray([len(tokens)], np.int32),
        return_hidden=True)
    return np.asarray(hidden)


@pytest.mark.parametrize("arch", ARCHS)
def test_prompt_is_padded_to_the_jax_bucket(references, arch, monkeypatch):
    """A 37-token (phi) or 41-token (llama4) prompt at P = 1 is prefilled at
    the JAX bucket of 64 tokens, whose zeros lift the capacity: its next-token hidden state is
    JAX's at that bucket and its stream is the JAX engine's. Prefilled at
    its own length (the dense stacks' rule) the capacity is lower, tokens
    the bucket keeps are dropped, and the hidden state (for phi the stream
    too) is another."""
    want = references()[f"{arch}|engine|{_layout_key(1, 1, 1)}"].tolist()
    vocab = _ctx(arch)["cfg"].vocab_size
    prompt = _pad_prompt(arch, vocab)
    bucket = _jax_prefill_hidden(arch, prompt, 64)
    at_own = _jax_prefill_hidden(arch, prompt, len(prompt))
    scale = np.abs(bucket).max()
    assert np.abs(bucket - at_own).max() > 1e-2 * scale
    out = {}
    for rule in ("bucket", "own"):
        eng = _port_engine(arch, 1, 1, 1)
        if rule == "own":
            monkeypatch.setattr(eng, "_padded", lambda t: torch.tensor([t]))
        hidden = []
        eng.on_prefill = lambda uid, h: hidden.append(h.numpy())
        eng.add_request(torch_engine.Request("pad", prompt, PAD_GEN))
        out[rule] = (eng.run()["pad"], hidden[0])
    stream, hidden = out["bucket"]
    assert stream == want
    assert np.abs(hidden - bucket).max() <= 1e-5 * scale
    stream, hidden = out["own"]
    assert np.abs(hidden - bucket).max() > 1e-2 * scale
    if arch == PHI:
        assert stream != want


@pytest.mark.parametrize("arch", ARCHS)
def test_legacy_tokens_match_jax_steps(arch):
    ctx = _ctx(arch)
    cfg_j = ctx["cfg_j"]
    plan_j = jax_make_serve_plan(cfg_j, arch=arch, n_devices=1, c=1)
    rng = np.random.default_rng(1)
    B, prompt_len, gen = 3, 11, 5
    tokens = rng.integers(0, cfg_j.vocab_size, (B, prompt_len))
    want = _jax_legacy_steps(cfg_j, jax.tree.map(jnp.asarray, ctx["tree"]),
                             plan_j, tokens, gen)
    model = from_jax_params(ctx["tree"], ctx["cfg"], "cpu")
    plan = make_serve_plan(ctx["cfg"], arch=arch, c=1)
    got = serve.legacy_generate(model, plan, torch.from_numpy(tokens), gen)
    np.testing.assert_array_equal(got.numpy(), want)


def test_chunked_prefill_rejected_for_moe():
    """Expert capacity couples a chunk's tokens to the rest of the prompt:
    the engine refuses the knob (the JAX test on the port)."""
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        torch_engine.build_engine(
            PHI, smoke=True, c=1, data=1, device="cpu",
            eng=torch_engine.EngineConfig(max_slots=1, page_size=4,
                                          pages_per_shard=32, max_len=64,
                                          prefill_chunk=8))


def test_prefix_cache_rejected_for_moe():
    from repro_torch.gateway import build_gateway

    for arch in ARCHS:
        with pytest.raises(NotImplementedError, match="MoE"):
            build_gateway(arch, smoke=True, c=1, data=1, replicas=1,
                          prefix_cache=True, device="cpu",
                          eng=torch_engine.EngineConfig(
                              max_slots=1, page_size=4, pages_per_shard=8,
                              max_len=32))
    with pytest.raises(AssertionError, match="excludes MoE"):
        serve_step.lm_prefill_paged(None, None, None, _ctx(PHI)["cfg"],
                                    prompt_len=8, cached_len=4, pools=None,
                                    table_row=None, page_size=4)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_launch_train_moe_on_eight_ranks(tmp_path):
    from repro_torch.launch import train

    metrics = tmp_path / "m.jsonl"
    out = train.main(["--arch", PHI, "--smoke", "--device", "cpu",
                      "--devices", "8", "--data", "2", "--c", "2",
                      "--steps", "6", "--metrics", str(metrics)])
    losses = [json.loads(x)["loss"] for x in metrics.read_text().splitlines()]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] and out["step"] == 6


def test_launch_serve_moe(capsys):
    serve.main(["--arch", LLAMA, "--smoke", "--device", "cpu",
                "--requests", "3"])
    text = capsys.readouterr().out
    assert text.count("[serve] req") == 3 and "finished=3" in text
    for flag in (["--prefill-chunk", "8"], ["--prefix-cache"]):
        with pytest.raises(NotImplementedError, match="MoE"):
            serve.main(["--arch", PHI, "--smoke", "--device", "cpu",
                        "--requests", "2", *flag])
