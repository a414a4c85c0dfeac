"""repro_torch's encoder-decoder family (``models/encdec.py``) against the
JAX package.

Smoke seamless-m4t-large-v2 (2 encoder + 2 decoder layers, d_model 64, 4
heads of 16, vocab 512), f32, with the JAX parameters carried across by
``from_jax_params`` and the same numpy inputs (tokens, labels and frame
embeddings from a numpy seed).

* The config and its smoke config equal JAX's field for field; the specs
  leaf for leaf and the full-width parameter count (2.04 B) equal JAX's.
* ``cross_attention_block`` against JAX's in local mode, output and every
  gradient (parameters, decoder input, encoder output), at P = 1 and on
  ``ThreadMesh(c=2, r=1)`` (its slices joined, its parameter gradients
  summed): within 2e-5 of the largest magnitude.
* ``encdec_loss``: the loss within 2e-3 absolute and every gradient leaf
  within 2e-3 of its largest magnitude (absolute for a leaf below 1;
  ROADMAP's parity rule): at P = 1 against the JAX local mode under each
  ``remat``, and at ``spmd_encdec``'s mesh (c, r, data) = (2, 1, 2)
  against the JAX spmd island under ``default``, ``fsdp`` and ``tp``.
  The scale matters for the ``embed.table`` and ``frontend_proj``
  gradients, of magnitude 16 and 11: the JAX local mode's own f32
  gradients lie 6.5e-3 and 4.2e-3 from its float64 ones there (the port's
  within 3.3e-3 and 1.2e-3 of JAX's f32), which is why JAX's
  ``spmd_encdec`` check bounds its gradients at 3e-2. (The JAX
  initialiser draws a stacked leaf at its layer count's fan-in scale,
  2 ** -0.5 in the smoke tree, so the attention is sharply peaked.)
* Precision: f32 does not determine this model's gradients to ``TOL``
  on the zigzag island's sequence. The zigzag layout computes the model
  on the batch's columns taken in position order. Evaluated exactly
  (float64 throughout: x64 with ``jnp.float32`` made float64 in the JAX
  child, ``_exact_torch`` in the port), both packages' islands at
  (c, r, data) = (2, 1, 1), (1, 4, 1) and (2, 1, 2), zigzag and
  contiguous, equal each other and P = 1 on that permuted sequence to
  1e-11 of a leaf's magnitude. On that sequence the f32 evaluations
  scatter: JAX's own P = 1 lies 2.4e-3 from exact and its zigzag island
  3.9e-3, the port's 2.3e-3 and 3.4e-3. (On the natural order the two
  packages' f32 gradients agree to 5e-4 at P = 1 and in the contiguous
  layout: the same operation order rounds alike.) So the zigzag island
  is held in f32 for its loss and exactly for every gradient leaf
  (``EXACT_TOL``), under each rule set; the f32 island in the
  contiguous layout is held at ``TOL``. ``torch_encdec_precision.py``
  beside this file prints these numbers.
* Serving: ``encdec_prefill`` against JAX's at P = 1 and against the
  ``build_prefill_step`` island at (2, 1, 2); ``encdec_decode_step`` fed
  the non-zero ``enc_out`` of JAX's prefill (capacity equal to the
  encoder's length) at several ``cache_len`` against JAX's (tokens equal,
  hidden state and written K/V within 2e-5 of the largest magnitude), and
  at ``serve_encdec``'s mesh against the JAX island's step.
* Teacher forcing: the port's decode steps over the decoder's tokens give
  the argmax of its full-forward logits at every position, at P = 1 and
  P = 4; ``legacy_generate``'s tokens are the full forward's argmax over
  the generated sequence.
* The three reference faults, pinned with nothing in the reference
  changed: JAX's ``--legacy`` raises for the family
  (``repro/launch/serve.py:95, :111``); zero frames (its
  ``_legacy_main``'s, ``:92``) make every JAX cross-attention block add
  exactly zero; JAX's cross decode over ``enc_out`` zero-padded to the
  decoder's capacity (``repro/serve/kv_cache.py:90-92``) differs from its
  decode at the encoder's length, which the port's equals.
* ``shard_batch`` splits ``frontend_emb`` on the sequence axis; the
  engine, the gateway and ``--http`` refuse the family with the JAX
  engine's reason; ``launch.serve --legacy`` on 4 ranks; ``launch.train``
  on 8 ranks with a checkpoint that saves and resumes; a checkpoint
  round-trips through the JAX package's format.
* The JAX references that need a mesh run in one child process with 8
  forced host devices, started by the first test so it overlaps the rest.
"""

import contextlib
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
from repro.models import encdec as jax_encdec
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
from repro_torch.models import encdec, transformer
from repro_torch.models.factory import (Model, build_model,
                                        from_jax_params, jax_tree,
                                        load_jax_tree, to_jax_layout)
from repro_torch.plan import make_plan, make_serve_plan
from repro_torch.serve import kv_cache
from repro_torch.serve import step as serve_step
from repro_torch.train import step as train_step
from test_torch_train_sp import mesh_whole_grads

ARCH = "seamless-m4t-large-v2"
SEQ, BATCH = 32, 2
TOL = 2e-3                               # a loss or gradient (ROADMAP;
                                         # a leaf's, of its magnitude)
BLOCK_TOL = 2e-5                         # a block's output (ROADMAP)
EXACT_TOL = 1e-9                         # the same, evaluated exactly
                                         # (float64 throughout)
ISLAND = (2, 1, 2)                       # spmd_encdec's and serve_encdec's
RULE_SETS = ["default", "fsdp", "tp"]
REMATS = ["none", "attn_out", "full"]
CACHE_LENS = (0, 7, 20, SEQ - 1)         # the decode step's positions
LEGACY = {"batch": 2, "prompt": 16, "gen": 5}
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
        batch["frontend_emb"] = rng.standard_normal(
            (BATCH, SEQ, cfg_j.d_model), dtype=np.float32)
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


def _jax_local_rt(model_j, seq=SEQ, kind="train"):
    return dataclasses.replace(jax_train_step.make_runtime(
        model_j, JaxRunConfig(c=1, seq_scheme="contiguous"),
        JaxShapeConfig("t", seq, BATCH, kind), mode="local"), batch_axes=())


def _decode_inputs(cfg):
    """The decode tests' cache contents: random decoder K/V (L, B, SEQ,
    Hkv, hd) and tokens (B, 1), from a numpy seed."""
    rng = np.random.default_rng(4)
    shape = (cfg.num_layers, BATCH, SEQ, cfg.num_kv_heads, cfg.head_dim_)
    return (rng.standard_normal(shape, dtype=np.float32),
            rng.standard_normal(shape, dtype=np.float32),
            rng.integers(0, cfg.vocab_size, (BATCH, 1), dtype=np.int32))


def _jax_cache(k, v, enc_out):
    return {"stack": {"sub0": {"k": jnp.asarray(k), "v": jnp.asarray(v)}},
            "enc_out": jnp.asarray(enc_out)}


# ---------------------------------------------------------------------------
# the JAX references on a mesh, in one child process with 8 host devices
# ---------------------------------------------------------------------------

def jax_references():
    """Everything the port is held against that needs a JAX mesh, as a
    flat dict of numpy arrays (run in the child process)."""
    from repro.dist import meshes

    out = {}
    ctx = _ctx()
    cfg, model = ctx["cfg_j"], ctx["model_j"]
    params = jax.tree.map(jnp.asarray, ctx["tree"])
    c, r, data = ISLAND
    mesh = meshes.local_mesh_for_tests(c=c, r=r, data=data)
    shape = JaxShapeConfig("test", seq_len=SEQ, global_batch=BATCH,
                           kind="train")
    for rules in RULE_SETS:
        fn, _ = jax_train_step.build_value_and_grad_fn(
            model, mesh, JaxRunConfig(c=c, seq_scheme="zigzag",
                                      sharding_rules=rules), shape)
        loss, grads = jax.jit(fn)(params, ctx["batch"])
        out[f"{rules}|loss"] = np.asarray(loss, np.float32)
        for path, g in jax.tree_util.tree_leaves_with_path(grads):
            out[f"{rules}|{jax.tree_util.keystr(path)}"] = \
                np.asarray(g, np.float32)
    fn, _ = jax_train_step.build_value_and_grad_fn(
        model, mesh, JaxRunConfig(c=c, seq_scheme="contiguous"), shape)
    loss, grads = jax.jit(fn)(params, ctx["batch"])
    out["contiguous|loss"] = np.asarray(loss, np.float32)
    for path, g in jax.tree_util.tree_leaves_with_path(grads):
        out[f"contiguous|{jax.tree_util.keystr(path)}"] = \
            np.asarray(g, np.float32)

    # the encoder prefill at P = 1 (local mode) and on the island's mesh
    pshape = JaxShapeConfig("t", SEQ, BATCH, "prefill")
    rt_l = _jax_local_rt(model, kind="prefill")
    enc = {k: ctx["batch"][k] for k in ("tokens", "frontend_emb")}
    out["prefill|1"] = np.asarray(jax.jit(
        lambda p_, b: jax_serve_step.encdec_prefill(rt_l, p_, b, cfg))(
            params, enc))
    jprefill, _ = jax_serve_step.build_prefill_step(
        model, mesh, JaxRunConfig(c=c, seq_scheme="contiguous"), pshape)
    out[f"prefill|{_key(*ISLAND)}"] = np.asarray(jprefill(params, enc))

    # serve_encdec: one decode step at cache_len SEQ - 1 on the island's
    # mesh, against the non-zero encoder output of the local prefill
    k, v, toks = _decode_inputs(cfg)
    dshape = JaxShapeConfig("t", seq_len=SEQ, global_batch=BATCH,
                            kind="decode")
    jdecode, _ = jax_serve_step.build_decode_step(
        model, mesh, JaxRunConfig(c=c, seq_scheme="contiguous"), dshape)
    tok, cache = jdecode(params, _jax_cache(k, v, out["prefill|1"]), toks)
    out["serve|tok"] = np.asarray(tok)
    out["serve|k"] = np.asarray(cache["stack"]["sub0"]["k"])

    # the zigzag island evaluated exactly: x64, and every float32 the
    # reference names made float64 (last: nothing after it runs so)
    jax.config.update("jax_enable_x64", True)
    jnp.float32 = jnp.float64
    params64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                            ctx["tree"])
    batch64 = dict(ctx["batch"], frontend_emb=np.asarray(
        ctx["batch"]["frontend_emb"], np.float64))
    for rules in RULE_SETS:
        fn, _ = jax_train_step.build_value_and_grad_fn(
            model, mesh, JaxRunConfig(c=c, seq_scheme="zigzag",
                                      sharding_rules=rules), shape)
        loss, grads = jax.jit(fn)(params64, batch64)
        out[f"{rules}|f64|loss"] = np.asarray(loss, np.float64)
        for path, g in jax.tree_util.tree_leaves_with_path(grads):
            out[f"{rules}|f64|{jax.tree_util.keystr(path)}"] = \
                np.asarray(g, np.float64)
    return out


_JAX_CHILD = r"""
import sys
import numpy as np
sys.path.insert(0, "tests")
from test_torch_encdec import jax_references
np.savez(sys.argv[1], **jax_references())
"""


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = tmp_path_factory.mktemp("encdec") / "references.npz"
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
# the config, the specs and the parameter layout
# ---------------------------------------------------------------------------

def _meta_model(cfg):
    return Model(cfg, lambda s: torch.empty(s.shape, device="meta"))


def test_configs_equal_jax(references):
    """Field for field, full and smoke (this test also starts the JAX
    child process); the decoder's period is JAX's ``layer_pattern``."""
    for cfg, cfg_j in ((registry.get(ARCH), jax_registry.get(ARCH)),
                       (registry.get_smoke(ARCH),
                        jax_registry.get_smoke(ARCH))):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
        assert cfg.encdec and cfg.frontend_stub == "frames"
        assert transformer.layer_pattern(cfg) == [("attn", "mlp")]
    # the VLM family is ported since (§A8 e): JAX's config
    assert dataclasses.asdict(registry.get_smoke("paligemma-3b")) == \
        dataclasses.asdict(jax_registry.get_smoke("paligemma-3b"))


def test_specs_and_parameter_count_equal_jax():
    """Every leaf's shape, logical axes, init and scale against JAX's
    ``encdec_specs`` (the port's per-layer leaves against a row of JAX's
    stacked ones); the full-width count: 2.04 B, JAX's."""
    for cfg, cfg_j in ((registry.get(ARCH), jax_registry.get(ARCH)),
                       (registry.get_smoke(ARCH),
                        jax_registry.get_smoke(ARCH))):
        model = _meta_model(cfg)
        specs_j = jax_encdec.encdec_specs(cfg_j)
        axes = model.axes()
        for name, p in model.named_parameters():
            parts = name.split(".")
            node = specs_j
            stacked = parts[0] in ("encoder", "decoder")
            for key in ([parts[0]] + parts[2:]) if stacked else parts:
                node = node[key]
            shape, ax = (node.shape[1:], node.axes[1:]) if stacked \
                else (node.shape, node.axes)
            assert (tuple(p.shape), axes[name]) == (shape, ax), name
        want = jax_build_model(cfg_j).param_count()
        assert model.param_count() == want
    assert 2.03e9 < _meta_model(registry.get(ARCH)).param_count() < 2.05e9


def test_jax_tree_round_trips_the_encdec_layout():
    """``from_jax_params`` then ``to_jax_layout`` give JAX's tree back,
    path for path and bit for bit (stacks ``encoder/*`` and ``decoder/*``
    with the layer leading, no ``sub<i>``)."""
    ctx = _ctx()
    model = from_jax_params(ctx["tree"], ctx["cfg"], "cpu")
    back = to_jax_layout(dict(model.named_parameters()), ctx["cfg"])
    want = jax.tree_util.tree_leaves_with_path(ctx["tree"])
    got = dict((jax.tree_util.keystr(p), g) for p, g in
               jax.tree_util.tree_leaves_with_path(back))
    assert sorted(got) == sorted(jax.tree_util.keystr(p) for p, _ in want)
    for p, w in want:
        np.testing.assert_array_equal(got[jax.tree_util.keystr(p)], w)
    assert sorted(ctx["tree"]) == ["decoder", "embed", "enc_norm", "encoder",
                                   "final_norm", "frontend_proj", "lm_head"]
    assert ctx["tree"]["decoder"]["cross"]["wq"].shape[0] == 2


def test_checkpoint_round_trips_in_the_jax_format(tmp_path):
    """The port's tree saved and restored by the JAX package, then back
    into a port model."""
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
# the cross-attention block
# ---------------------------------------------------------------------------

def _local_rt(cfg, seq=SEQ, scheme="contiguous"):
    plan = make_plan(cfg, ShapeConfig("t", seq, BATCH, "train"), n_devices=1)
    rt = train_step.make_runtime(_meta_model(cfg), plan.run_config(),
                                 plan.shape_config())
    return dataclasses.replace(rt, device=torch.device("cpu"),
                               st_cfg=dataclasses.replace(
                                   rt.st_cfg, seq_scheme=scheme))


def _rank_rt(comm, seq=SEQ):
    return train_step.make_runtime(
        _meta_model(registry.get_smoke(ARCH)),
        RunConfig(c=comm.axis_size("sp_team"), seq_scheme="contiguous"),
        ShapeConfig("t", seq, BATCH, "train"), comm)


def _cross_params(layer=0):
    """Decoder layer ``layer``'s cross-attention in both packages."""
    ctx = _ctx()
    model = from_jax_params(ctx["tree"], ctx["cfg"], "cpu")
    p_j = jax.tree.map(lambda a: a[layer], ctx["tree"]["decoder"]["cross"])
    return model.decoder[layer].cross, p_j


def _leaf_tree(tree):
    """A copy of a parameter namespace whose leaves require a gradient."""
    import types

    return types.SimpleNamespace(**{
        k: _leaf_tree(v) if isinstance(v, types.SimpleNamespace)
        else v.detach().clone().requires_grad_()
        for k, v in vars(tree).items()})


def _ns(module):
    import types

    out = {n: p for n, p in module.named_parameters(recurse=False)}
    for n, child in module.named_children():
        out[n] = _ns(child)
    return types.SimpleNamespace(**out)


def _flat(tree, prefix=""):
    for k, v in sorted(vars(tree).items()):
        if hasattr(v, "__dict__") and not isinstance(v, torch.Tensor):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_cross_attention_block_matches_jax_at_p1_and_on_a_mesh():
    """Output and the gradients of a fixed random projection of it, with
    respect to every parameter, the decoder input and the encoder output:
    at P = 1 and over ThreadMesh(c=2, r=1) (P = 4: each rank its slices
    of both sequences, the K/V gathered; the slices joined, the parameter
    gradients summed) against JAX's local mode, within ``BLOCK_TOL`` of
    the largest magnitude."""
    ctx = _ctx()
    cfg, cfg_j = ctx["cfg"], ctx["cfg_j"]
    p, p_j = _cross_params(1)
    rng = np.random.default_rng(5)
    x, enc, w = (rng.standard_normal((BATCH, SEQ, cfg.d_model),
                                     dtype=np.float32) for _ in range(3))
    rt_j = _jax_local_rt(ctx["model_j"])

    def f_j(p_, x_, e_):
        y = jax_encdec.cross_attention_block(rt_j, p_, x_, e_, cfg_j)
        return jnp.sum(y * w), y

    (_, y_j), g_j = jax.value_and_grad(f_j, argnums=(0, 1, 2),
                                       has_aux=True)(
        p_j, jnp.asarray(x), jnp.asarray(enc))
    want = {"out": y_j, "x": g_j[1], "enc": g_j[2]}
    for path, g in jax.tree_util.tree_leaves_with_path(g_j[0]):
        want[".".join(k.key for k in path)] = g

    base = _ns(p)
    pt = _leaf_tree(base)
    xt = torch.from_numpy(x).requires_grad_()
    et = torch.from_numpy(enc).requires_grad_()
    y = encdec.cross_attention_block(_rank_rt(SingleComm()), pt, xt, et, cfg)
    (y * torch.from_numpy(w)).sum().backward()
    got = {"out": y.detach(), "x": xt.grad, "enc": et.grad,
           **{n: t.grad for n, t in _flat(pt)}}
    assert sorted(got) == sorted(want)
    for n in want:
        _assert_scaled(got[n].numpy(), want[n], ("p1", n))

    mesh = ThreadMesh(2, 1)
    n_loc = SEQ // mesh.size

    def rank_fn(comm):
        rt = _rank_rt(comm)
        r = rt.sp_rank()
        sl = slice(r * n_loc, (r + 1) * n_loc)
        pr = _leaf_tree(base)
        xr = torch.from_numpy(x[:, sl].copy()).requires_grad_()
        er = torch.from_numpy(enc[:, sl].copy()).requires_grad_()
        yr = encdec.cross_attention_block(rt, pr, xr, er, cfg)
        (yr * torch.from_numpy(w[:, sl].copy())).sum().backward()
        return r, yr.detach(), xr.grad, er.grad, dict(_flat(pr))

    out = sorted(mesh.run(rank_fn, timeout=120), key=lambda t: t[0])
    got = {"out": torch.cat([o[1] for o in out], 1),
           "x": torch.cat([o[2] for o in out], 1),
           "enc": torch.cat([o[3] for o in out], 1)}
    for name in out[0][4]:
        got[name] = sum(o[4][name].grad for o in out)
    for n in want:
        _assert_scaled(got[n].numpy(), want[n], ("p4", n))


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def _leaf_errs(model, grads, want):
    """{JAX path: max |port - JAX| / max(1, max |JAX|)} of every gradient
    leaf (module doc), ``want`` a function of the JAX path."""
    names = [n for n, _ in model.named_parameters()]
    got = to_jax_layout(dict(zip(names, grads)), model.cfg)
    out = {}
    for p, g in jax.tree_util.tree_leaves_with_path(got):
        w = np.asarray(want(jax.tree_util.keystr(p)))
        out[jax.tree_util.keystr(p)] = float(
            np.max(np.abs(g - w)) / max(1.0, float(np.abs(w).max())))
    return out


def _torch_batch():
    return {k: torch.from_numpy(v) for k, v in _ctx()["batch"].items()}


def test_loss_and_grads_match_jax_local_mode():
    """At P = 1 under each ``remat``, against ``jax.value_and_grad`` of
    the JAX local-mode loss; the loss within ``TOL``, every gradient leaf
    within ``TOL`` of its magnitude (``_leaf_errs``)."""
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
    for remat in REMATS:
        vg, _ = train_step.build_value_and_grad_fn(
            model, RunConfig(c=1, remat=remat),
            ShapeConfig("test", SEQ, BATCH, "train"))
        loss, grads = vg(_torch_batch())
        assert abs(float(loss) - float(loss_j)) < TOL, remat
        errs = _leaf_errs(model, grads, flat.get)
        assert len(errs) == len(flat) and max(errs.values()) < TOL, errs
        assert all(bool(torch.isfinite(g).all()) for g in grads)


@contextlib.contextmanager
def _exact_torch():
    """Every float32 the port names made float64 (``torch.float32``,
    ``Tensor.float``, the default dtype) until exit: the port's exact
    evaluation, as the JAX child's under x64 with ``jnp.float32`` made
    float64 (module doc, "Precision")."""
    f32, to_f32 = torch.float32, torch.Tensor.float
    torch.float32, torch.Tensor.float = torch.float64, torch.Tensor.double
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.float32, torch.Tensor.float = f32, to_f32
        torch.set_default_dtype(f32)


def _island(scheme, rules, dtype):
    """(model, per-rank losses, whole gradients) of the port's island at
    ``ISLAND`` in ``scheme`` under ``rules``, its parameters and frames in
    ``dtype``."""
    ctx = _ctx()
    model = from_jax_params(ctx["tree"], ctx["cfg"], "cpu").to(dtype)
    batch = _torch_batch()
    batch["frontend_emb"] = batch["frontend_emb"].to(dtype)
    c, r, data = ISLAND
    losses, grads = mesh_whole_grads(
        model, ThreadMesh(c, r, data),
        RunConfig(c=c, seq_scheme=scheme, sharding_rules=rules),
        ShapeConfig("test", SEQ, BATCH, "train"), batch)
    return model, losses, grads


def _jax_leaves(want, key):
    """{JAX path: gradient} of the references ``key|...``."""
    return {k[len(key) + 1:]: v for k, v in want.items()
            if k.startswith(key + "|") and k[len(key) + 1:].startswith("[")}


@pytest.mark.parametrize("rules", RULE_SETS)
def test_loss_and_grads_match_the_jax_island(references, rules):
    """At ``spmd_encdec``'s mesh (c 2, r 1, data 2) on ``ThreadMesh``
    ranks, zigzag layout, against the JAX spmd island under the same rule
    set. In f32, the smoke config's dtype: the loss within ``TOL``, every
    gradient leaf finite. Both evaluated exactly (module doc, "Precision";
    f32 does not determine this island's gradients to ``TOL``, which
    ``test_f32_does_not_determine_the_zigzag_island`` pins): the loss and
    every gradient leaf within ``EXACT_TOL`` (``_leaf_errs``)."""
    want = references()
    _, losses, grads = _island("zigzag", rules, torch.float32)
    for loss in losses:
        assert abs(float(loss) - float(want[f"{rules}|loss"])) < TOL
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    with _exact_torch():                 # (``_leaf_errs`` reads f64 too)
        model, losses, grads = _island("zigzag", rules, torch.float64)
        errs = _leaf_errs(model, grads, lambda p: want[f"{rules}|f64|{p}"])
    for loss in losses:
        assert abs(float(loss) - float(want[f"{rules}|f64|loss"])) \
            < EXACT_TOL
    assert len(errs) == len(jax.tree.leaves(_ctx()["tree"]))
    assert max(errs.values()) < EXACT_TOL, errs


def test_f32_does_not_determine_the_zigzag_island(references):
    """The fact the island test is built on: the JAX island's own f32
    gradients (zigzag, ``default``) lie more than ``TOL`` of a leaf's
    magnitude from its exact evaluation (3.9e-3 measured), so the port's
    f32 gradients cannot be held to JAX's f32 ones within ``TOL``. If the
    reference grows this precise, hold the f32 island at ``TOL`` again."""
    want = references()
    f32, exact = _jax_leaves(want, "default"), _jax_leaves(want,
                                                           "default|f64")
    assert sorted(f32) == sorted(exact) and len(f32) == \
        len(jax.tree.leaves(_ctx()["tree"]))
    errs = {p: float(np.max(np.abs(f32[p] - exact[p]))
                     / max(1.0, float(np.abs(exact[p]).max())))
            for p in exact}
    assert max(errs.values()) > TOL, errs


def test_loss_and_grads_match_the_contiguous_jax_island_in_f32(references):
    """The same island in the contiguous layout, in f32 (the smoke
    config's dtype), against the JAX island in f32 under ``default``:
    the loss within ``TOL``, every gradient leaf within ``TOL`` of its
    magnitude."""
    want = references()
    model, losses, grads = _island("contiguous", "default", torch.float32)
    for loss in losses:
        assert abs(float(loss) - float(want["contiguous|loss"])) < TOL
    errs = _leaf_errs(model, grads, lambda p: want[f"contiguous|{p}"])
    assert len(errs) == len(jax.tree.leaves(_ctx()["tree"]))
    assert max(errs.values()) < TOL, errs


def test_shard_batch_splits_the_frames_on_the_sequence_axis():
    """Each rank's ``frontend_emb`` is its data rows and its SP rank's
    columns, as JAX's spec ``P(b, seq, None)`` places them."""
    batch = _torch_batch()
    model = _meta_model(_ctx()["cfg"])
    c, r, data = ISLAND

    def rank_fn(comm):
        rt = train_step.make_runtime(model, RunConfig(c=c),
                                     ShapeConfig("t", SEQ, BATCH, "train"),
                                     comm)
        return (comm.axis_index("data"), rt.sp_rank(),
                train_step.shard_batch(batch, rt))

    n = SEQ // (c * c * r)
    rows = BATCH // data
    for d, q, got in ThreadMesh(c, r, data).run(rank_fn):
        for k in ("frontend_emb", "tokens", "labels"):
            assert torch.equal(got[k], batch[k][d * rows:(d + 1) * rows,
                                                q * n:(q + 1) * n]), k
        assert got["frontend_emb"].shape == (rows, n, model.cfg.d_model)


# ---------------------------------------------------------------------------
# serving: the encoder prefill and the decode step
# ---------------------------------------------------------------------------

def _frames():
    return torch.from_numpy(_ctx()["batch"]["frontend_emb"])


def test_encdec_prefill_matches_jax(references):
    """At P = 1 against JAX's ``encdec_prefill`` in local mode, and on
    every rank of the (2, 1, 2) mesh (its rows and its contiguous slice)
    against the JAX ``build_prefill_step`` island."""
    want = references()
    ctx = _ctx()
    model = from_jax_params(ctx["tree"], ctx["cfg"], "cpu")
    shape = ShapeConfig("t", SEQ, BATCH, "prefill")
    out = serve_step.build_prefill_step(
        model, RunConfig(c=1, seq_scheme="contiguous"), shape)(_frames())
    assert len(out) == 1
    _assert_scaled(out[0].numpy(), want["prefill|1"], "p1")
    c, r, data = ISLAND
    fn = serve_step.build_prefill_step(
        model, RunConfig(c=c, seq_scheme="contiguous"), shape,
        ThreadMesh(c, r, data))
    outs = fn(_frames())
    whole = want[f"prefill|{_key(*ISLAND)}"]
    _assert_scaled(whole, want["prefill|1"], "JAX island against local")
    rows, n = BATCH // data, SEQ // (c * c * r)
    for rank, (d, sp) in enumerate(fn.steps.where):
        _assert_scaled(outs[rank].numpy(),
                       whole[d * rows:(d + 1) * rows, sp * n:(sp + 1) * n],
                       rank)


def _jax_decode_hidden(rt, params, cache, tokens, cfg, cache_len):
    """JAX's ``encdec_decode_step`` up to its pre-head hidden state, from
    its own parts (``_attn_decode``, ``_cross_decode``, ``mlp_block``)."""
    x = jax_blocks.embed(rt, params["embed"], tokens, cfg,
                         tokens_replicated=True)
    for i in range(cfg.num_layers):
        p = jax.tree.map(lambda a: a[i], params["decoder"])
        c = jax.tree.map(lambda a: a[i], cache["stack"]["sub0"])
        x, _ = jax_serve_step._attn_decode(rt, p["attn"], x, c, cfg,
                                           cache_len)
        x = jax_serve_step._cross_decode(rt, p["cross"], x,
                                         cache["enc_out"], cfg)
        x = jax_blocks.mlp_block(rt, p["mlp"], x, cfg)
    return jax_blocks.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def _port_cache(k, v, enc_out):
    return {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
            "enc_out": torch.from_numpy(np.asarray(enc_out).copy())}


def test_decode_step_matches_jax_on_a_non_zero_encoder_output(references):
    """P = 1, the capacity the encoder's length (SEQ), the ``enc_out`` of
    JAX's prefill and random decoder K/V: at each of ``CACHE_LENS`` the
    tokens equal JAX's ``encdec_decode_step``'s, and the hidden state and
    the K/V written at ``cache_len`` are within ``BLOCK_TOL`` of JAX's."""
    want = references()
    ctx = _ctx()
    cfg, cfg_j = ctx["cfg"], ctx["cfg_j"]
    params = jax.tree.map(jnp.asarray, ctx["tree"])
    model = from_jax_params(ctx["tree"], cfg, "cpu")
    k, v, toks = _decode_inputs(cfg)
    enc_out = want["prefill|1"]
    assert float(np.abs(enc_out).min(axis=-1).max()) > 0
    rt_j = _jax_local_rt(ctx["model_j"], kind="decode")
    fn = serve_step.build_decode_step(
        model, RunConfig(c=1, seq_scheme="contiguous"),
        ShapeConfig("t", SEQ, BATCH, "decode"))
    tt = torch.from_numpy(toks.astype(np.int64))
    for cl in CACHE_LENS:
        cache_j = _jax_cache(k, v, enc_out)
        tok_j, new_j = jax_serve_step.encdec_decode_step(
            rt_j, params, cache_j, jnp.asarray(toks), cfg_j, cl)
        hid_j = _jax_decode_hidden(rt_j, params, cache_j, jnp.asarray(toks),
                                   cfg_j, cl)
        cache = _port_cache(k, v, enc_out)
        cl_t = torch.full((BATCH,), cl, dtype=torch.int32)
        hid = fn([cache], tt, cl_t, return_hidden=True)
        cache = _port_cache(k, v, enc_out)
        tok = fn([cache], tt, cl_t)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_j))
        _assert_scaled(hid.numpy(), hid_j, ("hidden", cl))
        for n in ("k", "v"):
            _assert_scaled(cache[n][:, :, cl].numpy(),
                           np.asarray(new_j["stack"]["sub0"][n])[:, :, cl],
                           (n, cl))
    # serve_encdec's step at SEQ - 1 is the same token
    np.testing.assert_array_equal(tok.numpy(), want["serve|tok"])


def test_decode_step_at_serve_encdecs_mesh(references):
    """``serve_encdec``: one decode step at (c, r, data) = (2, 1, 2), the
    batch split over the replicas, each rank its slices of the K/V and of
    ``enc_out``, against the JAX island's step: tokens equal, the K/V
    written on the owning rank within ``BLOCK_TOL``."""
    want = references()
    ctx = _ctx()
    cfg = ctx["cfg"]
    model = from_jax_params(ctx["tree"], cfg, "cpu")
    k, v, toks = _decode_inputs(cfg)
    enc_out = want["prefill|1"]
    c, r, data = ISLAND
    fn = serve_step.build_decode_step(
        model, RunConfig(c=c, seq_scheme="contiguous"),
        ShapeConfig("t", SEQ, BATCH, "decode"), ThreadMesh(c, r, data))
    assert fn.steps.split and fn.steps.rows == 1
    n = SEQ // (c * c * r)
    caches = []
    for d, sp in fn.steps.where:
        rows, cols = slice(d, d + 1), slice(sp * n, (sp + 1) * n)
        caches.append(_port_cache(k[:, rows, cols], v[:, rows, cols],
                                  enc_out[rows, cols]))
    got = fn(caches, torch.from_numpy(toks.astype(np.int64)),
             torch.full((BATCH,), SEQ - 1, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), want["serve|tok"])
    whole = torch.cat([torch.cat([caches[rank]["k"] for rank in group], 2)
                       for group in fn.steps.groups()], 1)
    _assert_scaled(whole.numpy(), want["serve|k"], "k")


def test_zero_padded_encoder_output_changes_jaxs_decode_not_the_ports():
    """The reference fault of ``repro/serve/kv_cache.py:90-92``, pinned:
    JAX's cross decode over ``enc_out`` zero-padded from the encoder's 16
    positions to a capacity of 32 (its unmasked softmax weighs the zero
    rows) differs from its decode over the 16; the port's cache holds
    ``enc_out`` at the encoder's length and its decode equals the latter.
    The weights are the port's seeded fan-in-scaled ones (``build_model``)
    in both packages: the JAX initialiser takes a stacked leaf's leading
    (layer) dimension as its fan-in (``repro/models/spec.py:54``), so the
    smoke tree's projections are drawn at 2 ** -0.5 rather than 64 ** -0.5,
    the scores spread so wide that the zero rows' weight rounds to
    nothing."""
    ctx = _ctx()
    cfg, cfg_j = ctx["cfg"], ctx["cfg_j"]
    model = build_model(cfg, "cpu", seed=3)
    p = model.decoder[0].cross
    p_j = jax.tree.map(lambda a: jnp.asarray(a[0]), to_jax_layout(
        dict(model.named_parameters()), cfg)["decoder"]["cross"])
    rng = np.random.default_rng(6)
    x = rng.standard_normal((BATCH, 1, cfg.d_model), dtype=np.float32)
    enc = rng.standard_normal((BATCH, 16, cfg.d_model), dtype=np.float32)
    padded = np.concatenate([enc, np.zeros_like(enc)], axis=1)
    rt_j = _jax_local_rt(ctx["model_j"], kind="decode")
    y_enc = np.asarray(jax_serve_step._cross_decode(
        rt_j, p_j, jnp.asarray(x), jnp.asarray(enc), cfg_j))
    y_pad = np.asarray(jax_serve_step._cross_decode(
        rt_j, p_j, jnp.asarray(x), jnp.asarray(padded), cfg_j))
    assert np.abs(y_pad - y_enc).max() > 1e-2 * np.abs(y_enc - x).max()
    with torch.no_grad():
        y = serve_step._cross_decode(_local_rt(cfg, 16), p,
                                     torch.from_numpy(x),
                                     torch.from_numpy(enc), cfg)
    _assert_scaled(y.numpy(), y_enc, "port against JAX at the encoder length")
    cache = kv_cache.init_cache(cfg, BATCH, 32, "cpu", enc_len=16)
    assert cache["enc_out"].shape == (BATCH, 16, cfg.d_model)
    with pytest.raises(ValueError, match="enc_len"):
        kv_cache.init_cache(cfg, BATCH, 32, "cpu")


def test_zero_frames_make_jaxs_cross_attention_add_nothing():
    """The reference fault of ``repro/launch/serve.py:92``, pinned: with
    zero frames JAX's encoder output is exactly zero, so every JAX
    cross-attention block returns its input unchanged (a wrong
    cross-attention would not show); the port's ``--legacy`` feeds
    seeded random frames, whose encoder output is not zero."""
    ctx = _ctx()
    cfg_j = ctx["cfg_j"]
    params = jax.tree.map(jnp.asarray, ctx["tree"])
    rt_j = _jax_local_rt(ctx["model_j"], kind="prefill")
    zeros = jnp.zeros((BATCH, SEQ, cfg_j.d_model), jnp.float32)
    enc = jax_serve_step.encdec_prefill(rt_j, params,
                                        {"frontend_emb": zeros}, cfg_j)
    assert not np.asarray(enc).any()
    x = jnp.asarray(np.random.default_rng(7).standard_normal(
        (BATCH, SEQ, cfg_j.d_model), dtype=np.float32))
    for i in range(cfg_j.num_layers):
        p = jax.tree.map(lambda a: a[i], params["decoder"]["cross"])
        y = jax_encdec.cross_attention_block(rt_j, p, x, enc, cfg_j)
        np.testing.assert_array_equal(np.asarray(y), np.asarray(x))
    model = from_jax_params(ctx["tree"], ctx["cfg"], "cpu")
    out = serve_step.build_prefill_step(
        model, RunConfig(c=1, seq_scheme="contiguous"),
        ShapeConfig("t", SEQ, BATCH, "prefill"))(_frames())
    assert float(out[0].abs().min(dim=-1).values.max()) > 0


def test_jax_legacy_serve_raises_for_the_family():
    """The reference fault of ``repro/launch/serve.py:95, :111``, pinned:
    JAX's ``--legacy`` unpacks the encoder output as ``(tok, cache)`` and
    indexes it with 'stack', which JAX refuses."""
    from repro.launch import serve as jax_serve

    with pytest.raises(TypeError, match="string indexing"):
        jax_serve.main(["--arch", ARCH, "--smoke", "--legacy",
                        "--devices", "1", "--batch", "2",
                        "--prompt-len", "8", "--gen", "2"])


# ---------------------------------------------------------------------------
# teacher forcing and the static-batch launcher
# ---------------------------------------------------------------------------

def _full_argmax(model, frames, tokens):
    """The port's full forward (the training path's encoder and decoder,
    P = 1) -> the argmax of its logits at every decoder position."""
    cfg = model.cfg
    rt = _local_rt(cfg, tokens.shape[1])
    with torch.no_grad():
        enc_out = encdec.encode(rt, model, frames, cfg)
        x = encdec.decode(rt, model, tokens, enc_out, cfg)
        logits = torch.stack([sampling.shard_logits(
            rt, model.head, x[:, s:s + 1], cfg)[0]
            for s in range(tokens.shape[1])], 1)
    return logits.argmax(-1)


def _legacy_inputs(cfg):
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LEGACY["batch"], LEGACY["prompt"])))
    frames = torch.from_numpy(rng.standard_normal(
        (LEGACY["batch"], LEGACY["prompt"], cfg.d_model), dtype=np.float32))
    return tokens, frames


@pytest.mark.parametrize("n_devices", [1, 4])
def test_teacher_forced_decode_equals_the_full_forward_argmax(n_devices):
    """The decode steps over the decoder's tokens (each at its own
    position, K/V cache capacity SEQ, the encoder prefilled) give at every
    position the argmax of the full forward's logits (the forward whose
    loss is held against JAX above), at P = 1 and at P = 4 (c = 2)."""
    ctx = _ctx()
    cfg = ctx["cfg"]
    model = from_jax_params(ctx["tree"], cfg, "cpu")
    tokens = torch.from_numpy(ctx["batch"]["tokens"].astype(np.int64))
    frames = _frames()
    want = _full_argmax(model, frames, tokens)
    plan = make_serve_plan(cfg, arch=ARCH, n_devices=n_devices,
                           c=2 if n_devices > 1 else 1)
    assert plan.sp_size == n_devices
    caches, decode = serve.encdec_caches(model, plan, frames, SEQ)
    assert [c["enc_out"].shape[1] for c in caches] == \
        [SEQ // n_devices] * n_devices
    got = torch.cat([decode(caches, tokens[:, t:t + 1],
                            torch.full((BATCH,), t, dtype=torch.int32))
                     for t in range(SEQ)], 1)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("n_devices", [1, 4])
def test_legacy_tokens_are_the_full_forward_argmax(n_devices):
    """``legacy_generate`` at P = 1 and P = 4: the encoder prefilled, the
    prompt fed through decode steps, then the new tokens; each generated
    token is the full forward's argmax over the sequence before it."""
    ctx = _ctx()
    model = from_jax_params(ctx["tree"], ctx["cfg"], "cpu")
    tokens, frames = _legacy_inputs(model.cfg)
    plan = make_serve_plan(model.cfg, arch=ARCH, n_devices=n_devices,
                           c=2 if n_devices > 1 else 1)
    got = serve.legacy_generate(model, plan, tokens, LEGACY["gen"], frames)
    assert got.shape == (LEGACY["batch"], LEGACY["gen"])
    seq = torch.cat([tokens, got[:, :-1]], dim=1)
    full = _full_argmax(model, frames, seq)[:, LEGACY["prompt"] - 1:]
    np.testing.assert_array_equal(got.numpy(), full.numpy())
    with pytest.raises(ValueError, match="frames"):
        serve.legacy_generate(model, plan, tokens, 2)


def test_engine_gateway_and_launcher_refuse_encdec():
    """The JAX engine's reason, from the engine, the gateway, and
    ``launch.serve`` without ``--legacy`` (engine mode and ``--http``)."""
    from repro_torch.gateway import build_gateway

    ok, why = jax_paged_cache.supported(jax_registry.get_smoke(ARCH))
    assert not ok and "encoder-decoder" in why
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
    for extra in ([], ["--http", "--workers", "2"]):
        with pytest.raises(NotImplementedError) as e:
            serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--requests", "2"] + extra)
        assert str(e.value).endswith(why)


def test_launch_serve_legacy_on_four_ranks(capsys):
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--legacy", "--devices", "4", "--c", "2",
                      "--batch", "2", "--prompt-len", "16", "--gen", "3"])
    assert tuple(out.shape) == (2, 3)
    assert ((out >= 0) & (out < registry.get_smoke(ARCH).vocab_size)).all()
    assert "P_sp=4" in capsys.readouterr().out


def test_launch_train_on_eight_ranks_saves_and_resumes(tmp_path, capsys):
    """``launch.train`` on 8 ranks (data 2, c 2) from the pipeline's
    frames: finite losses; a JAX-format checkpoint that a rerun with more
    steps restores and continues from."""
    from repro.dist import checkpoint as jax_ckpt
    from repro_torch.launch import train

    ckpt, metrics = tmp_path / "ckpt", tmp_path / "m.jsonl"
    flags = ["--arch", ARCH, "--smoke", "--device", "cpu", "--devices", "8",
             "--data", "2", "--c", "2", "--ckpt-dir", str(ckpt),
             "--metrics", str(metrics)]
    out = train.main(flags + ["--steps", "2"])
    assert out["step"] == 2
    tree = jax_ckpt.restore(ckpt, 2, _ctx()["tree"])
    assert sorted(tree) == sorted(_ctx()["tree"])
    out = train.main(flags + ["--steps", "3"])
    text = capsys.readouterr().out
    assert out["step"] == 3 and "restored step 2" in text
    assert "P_sp=4" in text and "data=2" in text
    losses = [json.loads(x)["loss"] for x in metrics.read_text().splitlines()]
    assert len(losses) == 3 and all(np.isfinite(losses))
