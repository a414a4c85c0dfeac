"""repro_torch's xLSTM family (``models/ssm.py``) against the JAX package.

Smoke xlstm-1.3b (2 layers: an mLSTM then an sLSTM, d_model 64, 2 heads,
chunk 8), f32, with the JAX parameters carried across by
``from_jax_params`` and the same numpy inputs.

* The config and its smoke config equal JAX's field for field;
  ``layer_pattern`` and ``mixer_on_layer`` match; paligemma, jamba and
  seamless-m4t (ported since) give JAX's config and period.
* ``chunked_gla`` against JAX's and the naive recurrence of
  ``tests/test_ssm_and_roofline.py`` at chunks 2-16 and a sequence shorter
  than the chunk, within 2e-5 (that file's bound), a zero decay giving the
  cumulative sums; ``mlstm_block`` and ``slstm_block`` against JAX's in
  local mode within 2e-5 of the largest magnitude (as ``test_torch_moe``:
  the mLSTM's output and state reach ~3e3 at the smoke init, where f32
  rounding alone is ~1e-6 of it in either package).
* Loss and every gradient leaf within 2e-3 (``check_spmd_model``'s bound):
  at P = 1 against the JAX local mode; on ``ThreadMesh`` (c, r, data) =
  (2, 1, 2), (1, 4, 2) and (2, 2, 1) against the JAX spmd island at the
  same mesh under ``default`` and ``fsdp`` (the sLSTM's shard-local state
  makes P > 1 differ from P = 1 by construction), and under ``tp`` against
  the JAX ``default`` island: the JAX ``tp`` island differs from its
  ``default`` one, because its sLSTM reads the ``tp``-sharded ``r`` raw
  (``repro/models/ssm.py:304``), while the port gathers it. Three train
  steps at (2, 1, 2) against JAX ``build_train_step`` (lr 1e-2, as
  ``check_spmd_train_step``): losses within 2e-3, falling.
* Serving: the prefill's recurrent states at P = 1 and at (2, 1, 2)
  against the JAX ``lm_prefill`` cache within 2e-5 of their largest
  magnitude; one decode step at
  (c, data) = (2, 2) gives ``serve_xlstm``'s tokens; ``--legacy`` at
  P = 1 and P = 4 gives the tokens of the JAX prefill and decode islands.
  The engine, the gateway and ``launch.serve`` without ``--legacy`` refuse
  the family with the JAX engine's reason; both launchers run the smoke
  config; a checkpoint round-trips through the JAX package's format.
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
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_transformer
from repro.models.factory import build_model as jax_build_model
from repro.train import step as jax_train_step
from repro_torch import engine as torch_engine
from repro_torch.configs import registry
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.dist import checkpoint
from repro_torch.dist.comm import ThreadMesh
from repro_torch.launch import serve
from repro_torch.models import ssm, transformer
from repro_torch.models.factory import (Model, build_model,
                                        from_jax_params, jax_tree,
                                        load_jax_tree, to_jax_layout)
from repro_torch.optim import adamw
from repro_torch.plan import make_plan, make_serve_plan
from repro_torch.serve import kv_cache
from repro_torch.serve import step as serve_step
from repro_torch.train import step as train_step
from test_torch_train_sp import mesh_whole_grads

ARCH = "xlstm-1.3b"
SEQ, BATCH = 32, 2
TOL = 2e-3                               # check_spmd_model's bound
BLOCK_TOL = 2e-5                         # tests/test_ssm_and_roofline.py's
MESHES = [(2, 1, 2), (1, 4, 2), (2, 2, 1)]
ISLAND = MESHES[0]
SERVE_MESH = (2, 1, 2)                   # serve_xlstm's (c, r, data)
LEGACY = {"batch": 3, "prompt": 16, "gen": 5}
LEGACY_SP = (1, 4)                       # n_devices of the --legacy runs
ADAM_STEP = dict(learning_rate=1e-2, warmup_steps=0)
_CTX = {}


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
    from repro.serve import step as jax_serve_step
    from test_torch_legacy import _jax_legacy_steps

    out = {}
    ctx = _ctx()
    model, cfg = ctx["model_j"], ctx["cfg_j"]
    params = jax.tree.map(jnp.asarray, ctx["tree"])
    shape = JaxShapeConfig("test", seq_len=SEQ, global_batch=BATCH,
                           kind="train")
    for c, r, data in MESHES:
        mesh = meshes.local_mesh_for_tests(c=c, r=r, data=data)
        rule_sets = ["default", "fsdp"] + (["tp"] if (c, r, data) == ISLAND
                                           else [])
        for rules in rule_sets:
            fn, _ = jax_train_step.build_value_and_grad_fn(
                model, mesh, JaxRunConfig(c=c, seq_scheme="zigzag",
                                          sharding_rules=rules), shape)
            loss, grads = jax.jit(fn)(params, ctx["batch"])
            key = f"{_key(c, r, data)}|{rules}"
            out[f"{key}|loss"] = np.asarray(loss, np.float32)
            for path, g in jax.tree_util.tree_leaves_with_path(grads):
                out[f"{key}|{jax.tree_util.keystr(path)}"] = \
                    np.asarray(g, np.float32)

    # three train steps (check_spmd_train_step) on the island's mesh
    c, r, data = ISLAND
    mesh = meshes.local_mesh_for_tests(c=c, r=r, data=data)
    jstep, _ = jax_train_step.build_train_step(
        model, mesh, JaxRunConfig(c=c, seq_scheme="zigzag"), shape,
        jax_adamw.AdamWConfig(**ADAM_STEP))
    p = jax.tree.map(jnp.array, ctx["tree"])    # the step donates its inputs
    opt = jax_adamw.init_state(p, jax_adamw.AdamWConfig(**ADAM_STEP))
    metrics = []
    for _ in range(3):
        p, opt, m = jstep(p, opt, ctx["batch"])
        metrics.append([float(m["loss"]), float(m["grad_norm"])])
    out["steps"] = np.asarray(metrics)

    # the prefill's cache at P = 1 (local mode) and on the island's mesh
    tokens = ctx["batch"]["tokens"]
    rt_l = dataclasses.replace(jax_train_step.make_runtime(
        model, JaxRunConfig(c=1, seq_scheme="contiguous"),
        JaxShapeConfig("t", SEQ, BATCH, "prefill"), mode="local"),
        batch_axes=())
    tok, cache = jax.jit(lambda p_, t: jax_serve_step.lm_prefill(
        rt_l, p_, {"tokens": t}, cfg))(params, tokens)
    out["prefill|1|tok"] = np.asarray(tok)
    for path, leaf in jax.tree_util.tree_leaves_with_path(cache):
        out[f"prefill|1|{jax.tree_util.keystr(path)}"] = np.asarray(leaf)
    jprefill, _ = jax_serve_step.build_prefill_step(
        model, mesh, JaxRunConfig(c=c, seq_scheme="contiguous"),
        JaxShapeConfig("t", SEQ, BATCH, "prefill"))
    tok, cache = jprefill(params, {"tokens": tokens})
    out[f"prefill|{_key(*ISLAND)}|tok"] = np.asarray(tok)
    for path, leaf in jax.tree_util.tree_leaves_with_path(cache):
        out[f"prefill|{_key(*ISLAND)}|{jax.tree_util.keystr(path)}"] = \
            np.asarray(leaf)

    # serve_xlstm: one decode step at (c, data) = (2, 2) and in local mode
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

    # --legacy: the prefill and contiguous-decode islands
    legacy = _legacy_tokens(cfg.vocab_size)
    for n in LEGACY_SP:
        plan = jax_make_serve_plan(cfg, arch=ARCH, n_devices=n,
                                   c=2 if n > 1 else 1)
        out[f"legacy|{n}"] = _jax_legacy_steps(cfg, params, plan, legacy,
                                               LEGACY["gen"])
    return out


_JAX_CHILD = r"""
import sys
import numpy as np
sys.path.insert(0, "tests")
from test_torch_xlstm import jax_references
np.savez(sys.argv[1], **jax_references())
"""


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = tmp_path_factory.mktemp("xlstm") / "references.npz"
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

def test_configs_equal_jax(references):
    """Field for field, full and smoke (this test also starts the JAX
    child process); the period and each layer's mixer are JAX's."""
    for cfg, cfg_j in ((registry.get(ARCH), jax_registry.get(ARCH)),
                       (registry.get_smoke(ARCH),
                        jax_registry.get_smoke(ARCH))):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
        assert [cfg.mixer_on_layer(i) for i in range(cfg.num_layers)] == \
            [cfg_j.mixer_on_layer(i) for i in range(cfg.num_layers)]
        assert transformer.layer_pattern(cfg) == \
            jax_transformer.layer_pattern(cfg_j)
    assert transformer.layer_pattern(registry.get(ARCH)) == \
        [("mlstm", None)] * 7 + [("slstm", None)]
    assert transformer.layer_kinds(registry.get(ARCH)) == [None] * 48
    assert not transformer.has_moe(registry.get(ARCH))
    for other in ("paligemma-3b", "seamless-m4t-large-v2",
                  "jamba-1.5-large-398b"):
        cfg_o = jax_registry.get_smoke(other)
        as_h2o = dataclasses.replace(registry.get_smoke("h2o-danube-1.8b"),
                                     family=cfg_o.family, encdec=cfg_o.encdec)
        # the hybrid (§A8 c), encoder-decoder (§A8 d) and VLM (§A8 e)
        # families are ported: JAX's config and period
        assert dataclasses.asdict(registry.get_smoke(other)) == \
            dataclasses.asdict(cfg_o)
        assert transformer.layer_pattern(as_h2o) == \
            jax_transformer.layer_pattern(dataclasses.replace(
                jax_registry.get_smoke("h2o-danube-1.8b"),
                family=cfg_o.family))


def test_specs_and_parameter_count_equal_jax():
    """Every mixer leaf's shape, logical axes, init and scale; the
    full-width model's parameter count (meta device)."""
    cfg, cfg_j = registry.get(ARCH), jax_registry.get(ARCH)
    for kind in ("mlstm", "slstm"):
        specs = ssm.MIXERS[kind][0](cfg)
        specs_j = getattr(jax_ssm, f"{kind}_specs")(cfg_j)
        assert sorted(specs) == sorted(specs_j)
        for name in specs:
            a, b = specs[name], specs_j[name]
            if isinstance(a, dict):
                a, b = a["scale"], b["scale"]
            assert (a.shape, a.axes, a.init, a.scale) == \
                (b.shape, b.axes, b.init, b.scale), (kind, name)
    want = jax_build_model(cfg_j).param_count()
    assert _meta_model(cfg).param_count() == want
    assert 1.0e9 < want < 1.1e9


# ---------------------------------------------------------------------------
# the recurrence and the blocks
# ---------------------------------------------------------------------------

def _naive_gla(q, k, v, ld):
    """The token-by-token recurrence (``test_ssm_and_roofline.naive_gla``)
    in numpy, f64."""
    B, S, H, N = q.shape
    h = np.zeros((B, H, N, v.shape[-1]))
    ys = []
    for t in range(S):
        h = h * np.exp(ld[:, t])[..., None, None] \
            + k[:, t, ..., :, None] * v[:, t, ..., None, :]
        ys.append(np.einsum("bhn,bhnp->bhp", q[:, t], h))
    return np.stack(ys, 1), h


@pytest.mark.parametrize("chunk,seq", [(2, 16), (4, 16), (8, 16), (16, 16),
                                       (16, 6)])
def test_chunked_gla_matches_jax_and_the_recurrence(chunk, seq):
    rng = np.random.default_rng(chunk + seq)
    B, H, N, P = 2, 2, 3, 4
    q, k = (rng.normal(size=(B, seq, H, N)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(B, seq, H, P)).astype(np.float32)
    ld = (-np.abs(rng.normal(size=(B, seq, H))) * 0.5).astype(np.float32)
    got = ssm.chunked_gla(*(torch.from_numpy(a) for a in (q, k, v, ld)),
                          chunk)
    want = jax_ssm.chunked_gla(*(jnp.asarray(a) for a in (q, k, v, ld)),
                               chunk)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=BLOCK_TOL,
                                   rtol=BLOCK_TOL)
    y_ref, h_ref = _naive_gla(*(a.astype(np.float64) for a in (q, k, v, ld)))
    np.testing.assert_allclose(got[0].numpy(), y_ref, atol=BLOCK_TOL,
                               rtol=BLOCK_TOL)
    np.testing.assert_allclose(got[1].numpy(), h_ref, atol=BLOCK_TOL,
                               rtol=BLOCK_TOL)
    np.testing.assert_allclose(got[2].numpy(), ld.sum(1), atol=BLOCK_TOL,
                               rtol=BLOCK_TOL)
    np.testing.assert_allclose(got[3].numpy(), np.cumsum(ld, 1),
                               atol=BLOCK_TOL, rtol=BLOCK_TOL)


def test_chunked_gla_without_decay_is_a_cumulative_sum():
    """log decay 0, q = 1, k = 1 (N = 1): y_t = sum_{j<=t} v_j; and a chunk
    that does not divide the sequence raises as JAX's does."""
    rng = np.random.default_rng(3)
    v = torch.from_numpy(rng.normal(size=(1, 16, 2, 3)).astype(np.float32))
    ones = torch.ones((1, 16, 2, 1))
    y, h, ld_tot, la = ssm.chunked_gla(ones, ones, v, torch.zeros(1, 16, 2),
                                       4)
    np.testing.assert_allclose(y.numpy(), np.cumsum(v.numpy(), 1),
                               atol=BLOCK_TOL, rtol=BLOCK_TOL)
    assert float(ld_tot.abs().max()) == float(la.abs().max()) == 0.0
    with pytest.raises(ValueError, match="% chunk"):
        ssm.chunked_gla(ones[:, :12], ones[:, :12], v[:, :12],
                        torch.zeros(1, 12, 2), 8)
    with pytest.raises(ValueError, match="% chunk"):
        jax_ssm.chunked_gla(*(jnp.asarray(a[:, :12].numpy())
                              for a in (ones, ones, v)),
                            jnp.zeros((1, 12, 2)), 8)


def _meta_model(cfg):
    return Model(cfg, lambda s: torch.empty(s.shape, device="meta"))


def _local_rt(cfg, seq=SEQ):
    plan = make_plan(cfg, ShapeConfig("t", seq, BATCH, "train"), n_devices=1)
    return dataclasses.replace(train_step.make_runtime(
        _meta_model(cfg), plan.run_config(), plan.shape_config()),
        device=torch.device("cpu"))


@pytest.mark.parametrize("kind,sub", [("mlstm", "sub0"), ("slstm", "sub1")])
def test_blocks_match_jax_local_mode(kind, sub):
    """Each block's output (and its returned state) against JAX's in local
    mode on the same input."""
    ctx = _ctx()
    cfg, cfg_j = ctx["cfg"], ctx["cfg_j"]
    p_j = jax.tree.map(lambda a: a[0], ctx["tree"]["stack"][sub]["mixer"])
    model = from_jax_params(ctx["tree"], cfg, "cpu")
    p = model.layers[0 if kind == "mlstm" else 1].mixer
    x = np.random.default_rng(5).normal(
        size=(BATCH, SEQ, cfg.d_model)).astype(np.float32)
    rt_j = jax_train_step.make_runtime(
        ctx["model_j"], JaxRunConfig(c=1), JaxShapeConfig("t", SEQ, BATCH,
                                                         "train"),
        mode="local")
    y_j, st_j = getattr(jax_ssm, f"{kind}_block")(
        rt_j, p_j, jnp.asarray(x), cfg_j, return_state=True)
    with torch.no_grad():
        y, st = ssm.MIXERS[kind][1](_local_rt(cfg), p, torch.from_numpy(x),
                                    cfg, return_state=True)
    _assert_scaled(y.numpy(), y_j, kind)
    assert sorted(st) == sorted(st_j)
    for n in st:
        _assert_scaled(st[n].numpy(), st_j[n], n)


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


def test_loss_and_grads_match_jax_local_mode():
    ctx = _ctx()
    model_j = ctx["model_j"]
    rt_j = jax_train_step.make_runtime(
        model_j, JaxRunConfig(c=1), JaxShapeConfig("test", SEQ, BATCH,
                                                   "train"), mode="local")
    loss_j, grads_j = jax.jit(jax.value_and_grad(lambda p: model_j.loss(
        rt_j, p, ctx["batch"], remat="none")))(ctx["tree"])
    flat = {jax.tree_util.keystr(p): np.asarray(g) for p, g in
            jax.tree_util.tree_leaves_with_path(grads_j)}
    model = from_jax_params(ctx["tree"], ctx["cfg"], "cpu")
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


@pytest.mark.parametrize("rules", ["default", "fsdp", "tp"])
@pytest.mark.parametrize("c,r,data", MESHES,
                         ids=["c2r1d2", "c1r4d2", "c2r2d1"])
def test_loss_and_grads_match_the_jax_island(references, c, r, data, rules):
    """Held against the JAX spmd island at the same mesh (``tp`` against
    its ``default`` island: the port gathers the sLSTM's ``r``)."""
    want = references()
    ctx = _ctx()
    model = from_jax_params(ctx["tree"], ctx["cfg"], "cpu")
    losses, grads = mesh_whole_grads(
        model, ThreadMesh(c, r, data),
        RunConfig(c=c, seq_scheme="zigzag", sharding_rules=rules),
        ShapeConfig("test", SEQ, BATCH, "train"),
        {k: torch.from_numpy(v) for k, v in ctx["batch"].items()})
    key = f"{_key(c, r, data)}|{'default' if rules == 'tp' else rules}"
    for loss in losses:
        assert abs(float(loss) - float(want[f"{key}|loss"])) < TOL
    errs = _leaf_errs(model, grads, lambda p: want[f"{key}|{p}"])
    assert len(errs) == len(jax.tree.leaves(ctx["tree"]))
    assert max(errs.values()) < TOL, errs
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_jax_tp_island_differs_from_its_default_one(references):
    """The reference fault the port does not copy: under ``tp`` the JAX
    sLSTM reads its ``heads``-sharded ``r`` raw
    (``repro/models/ssm.py:304``), one head's slice broadcast over both
    heads, so the island's loss and gradients leave its ``default``
    ones."""
    want = references()
    key = _key(*ISLAND)
    d, t = want[f"{key}|default|loss"], want[f"{key}|tp|loss"]
    assert abs(float(t) - float(d)) > 1e-5
    r_path = "['stack']['sub1']['mixer']['r']"
    assert np.abs(want[f"{key}|tp|{r_path}"]
                  - want[f"{key}|default|{r_path}"]).max() > 1e-4


def test_three_mesh_train_steps_match_jax(references):
    want = references()["steps"]
    ctx = _ctx()
    cfg = ctx["cfg"]
    model = from_jax_params(ctx["tree"], cfg, "cpu")
    plan = make_plan(cfg, ShapeConfig("test", SEQ, BATCH, "train"),
                     n_devices=8, data=2, c=2)
    assert (plan.c, plan.r, plan.data) == ISLAND
    assert plan.run_config().seq_scheme == "contiguous"
    step, sh = plan.build_train_step(model, adamw.AdamWConfig(**ADAM_STEP))
    opt = adamw.init_state(sh["params"], adamw.AdamWConfig(**ADAM_STEP))
    batch = {k: torch.from_numpy(v) for k, v in ctx["batch"].items()}
    losses = []
    for i, (loss_j, gnorm_j) in enumerate(want):
        opt, m = step(opt, batch)
        assert abs(float(m["loss"]) - loss_j) < TOL, (i, "loss")
        assert abs(float(m["grad_norm"]) - gnorm_j) < TOL, (i, "grad_norm")
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_runtime_forces_the_contiguous_layout():
    """A zigzag run config still lays an SSM stack's sequence out
    contiguously (the state passing needs it), as JAX's ``make_runtime``
    does; a dense stack keeps zigzag."""
    for arch, want in ((ARCH, "contiguous"), ("h2o-danube-1.8b", "zigzag")):
        rt = train_step.make_runtime(
            _meta_model(registry.get_smoke(arch)),
            RunConfig(c=1, seq_scheme="zigzag"),
            ShapeConfig("t", SEQ, BATCH, "train"))
        assert rt.st_cfg.seq_scheme == want


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _state_leaf(want, where, sub, name):
    return want[f"prefill|{where}|['stack']['{sub}']['{name}']"][0]


def test_prefill_states_match_jax(references):
    """The mLSTM's corrected final state and the sLSTM's (h, c) of the last
    rank, at P = 1 and on every rank of the (2, 1, 2) mesh, against the
    JAX ``lm_prefill`` cache; the first tokens too."""
    want = references()
    ctx = _ctx()
    cfg = ctx["cfg"]
    model = from_jax_params(ctx["tree"], cfg, "cpu")
    tokens = torch.from_numpy(ctx["batch"]["tokens"].astype(np.int64))
    subs = {"state": "sub0", "h": "sub1", "c": "sub1"}
    shape = ShapeConfig("t", SEQ, BATCH, "prefill")
    run_cfg = RunConfig(c=1, seq_scheme="contiguous")
    tok, caches = serve_step.build_prefill_step(model, run_cfg, shape)(tokens)
    np.testing.assert_array_equal(tok.numpy(), want["prefill|1|tok"])
    assert len(caches) == 1
    for layer in caches[0]:
        for n, t in layer.items():
            _assert_scaled(t.numpy(), _state_leaf(want, 1, subs[n], n), n)
    c, r, data = ISLAND
    fn = serve_step.build_prefill_step(model, RunConfig(
        c=c, seq_scheme="contiguous"), shape, ThreadMesh(c, r, data))
    tok, caches = fn(tokens)
    where = _key(*ISLAND)
    np.testing.assert_array_equal(tok.numpy(), want[f"prefill|{where}|tok"])
    rows = BATCH // data
    for rank, (d, _) in enumerate(fn.steps.where):
        for layer in caches[rank]:
            for n, t in layer.items():
                _assert_scaled(t.numpy(), _state_leaf(want, where, subs[n],
                                                      n)[d * rows:
                                                         (d + 1) * rows],
                               (rank, n))


def test_decode_step_at_c2_data2_gives_serve_xlstms_tokens(references):
    """``serve_xlstm``: one decode step from zero states at (c, r, data) =
    (2, 1, 2), the batch split over the replicas, against the JAX spmd and
    local-mode steps; the states advance in place on every rank."""
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
        assert float(cache[1]["h"].abs().max()) > 0


@pytest.mark.parametrize("n_devices", LEGACY_SP)
def test_legacy_tokens_match_jax_steps(references, n_devices):
    """``legacy_generate`` at P = 1 and P = 4 (c = 2, r = 1): the JAX
    prefill island, the states carried over, then the decode island (exact
    for xLSTM, whose steps do not read ``cache_len``)."""
    want = references()[f"legacy|{n_devices}"]
    ctx = _ctx()
    cfg = ctx["cfg"]
    model = from_jax_params(ctx["tree"], cfg, "cpu")
    plan = make_serve_plan(cfg, arch=ARCH, n_devices=n_devices,
                           c=2 if n_devices > 1 else 1)
    assert plan.sp_size == n_devices
    tokens = torch.from_numpy(_legacy_tokens(cfg.vocab_size))
    got = serve.legacy_generate(model, plan, tokens, LEGACY["gen"])
    assert got.shape == (LEGACY["batch"], LEGACY["gen"])
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_gateway_and_launcher_refuse_xlstm():
    """Recurrent per-slot states have no paged layout: the JAX engine's
    reason, from the engine, the gateway and ``launch.serve`` without
    ``--legacy``."""
    from repro_torch.gateway import build_gateway

    ok, why = jax_paged_cache.supported(jax_registry.get_smoke(ARCH))
    assert not ok and "recurrent state" in why
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


def test_launch_train_xlstm_on_eight_ranks(tmp_path, capsys):
    """Each step a fresh synthetic batch of random tokens (the loss stays
    near ln 256): finite losses, every step taken, on the plan's mesh."""
    from repro_torch.launch import train

    metrics = tmp_path / "m.jsonl"
    out = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--devices", "8", "--data", "2", "--c", "2",
                      "--rules", "tp", "--steps", "4",
                      "--metrics", str(metrics)])
    losses = [json.loads(x)["loss"] for x in metrics.read_text().splitlines()]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert len(set(losses)) == 4 and out["step"] == 4
    text = capsys.readouterr().out
    assert "P_sp=4" in text and "data=2" in text and "rules=tp" in text


def test_checkpoint_round_trips_in_the_jax_format(tmp_path):
    """The port's xLSTM tree saved and restored by the JAX package (its
    flatten order of the per-kind sub-layers), then back into a port
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
