"""repro_torch's VLM prefix-LM (paligemma-3b) against the JAX package.

Smoke paligemma-3b (2 layers, d_model 64, 4 query heads on one kv head of
16, vocab 512), f32, with the JAX parameters carried across by
``from_jax_params`` and the same numpy inputs (tokens, labels and patch
embeddings from a numpy seed). The image prefix is the sequence's first
``int(0.125 * seq_len)`` positions: their embeddings are the patches, every
query sees them (the prefix-LM mask), and they leave the loss.

* The config and its smoke config equal JAX's field for field; the specs
  leaf for leaf and the full-width parameter count (3 035 441 152) equal
  JAX's; the tree round-trips through the JAX layout and its checkpoint
  format.
* ``lm_loss`` with ``frontend_emb``: the loss within 2e-3 absolute and
  every gradient leaf within 2e-3 of its largest magnitude (absolute for a
  leaf below 1; ROADMAP's parity rule), at P = 1 against the JAX local
  mode under each ``remat``, and at ``spmd_vlm``'s mesh (c, r, data) =
  (2, 1, 2) against the JAX spmd island under ``default``, ``fsdp`` and
  ``tp``, the batch and the patches permuted into the shard order as
  ``check_spmd_model`` permutes them. Without patches (or with a prefix of
  0 positions) the loss is the text-only loss.
* StarTrail with ``prefix_len`` (zigzag, the prefix over several ranks) at
  P = 4 and 8, forward and backward, against ``jax.grad`` of
  ``repro.kernels.ref.mha_reference(prefix_len=)`` within the dist
  checks' 2e-4; ``fully_masked`` skips exactly the ring steps JAX's
  ``_fully_masked`` skips.
* Serving: ``lm_prefill`` with patches against JAX's (tokens equal, K/V
  within 2e-5 of the largest magnitude) at P = 1 and on every rank of the
  ``build_prefill_step`` island at (c, r, data) = (2, 1, 2); the
  static-batch steps (prefill with patches, then decode steps at each
  step's true ``cache_len`` with no prefix) give the JAX steps' tokens at
  P = 1 and P = 4; teacher forcing at P = 1 and P = 4 gives the full
  forward's argmax at the prompt's ``prefix_len``.
* JAX's ``--legacy`` zero patches keep the prefix rows exactly zero in
  every layer (``repro/launch/serve.py:91-94``, pinned; ROADMAP §C); the
  port's ``--legacy`` draws seeded patches, whose rows are not.
* The engine, the gateway and ``--http`` refuse the family with the JAX
  engine's reason; ``launch.serve --legacy`` at P = 1 and 4;
  ``launch.train`` on 8 ranks with a checkpoint that saves and resumes;
  the plan refuses ``--scheme ulysses`` as JAX's does; ``plan/cost.py``'s
  costs for paligemma equal JAX's.
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
from jax.sharding import PartitionSpec as P

from repro.configs import registry as jax_registry
from repro.configs.base import RunConfig as JaxRunConfig
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.core import startrail as jax_st
from repro.core import zigzag as jax_zz
from repro.engine import paged_cache as jax_paged_cache
from repro.kernels import ref as jax_ref
from repro.models import blocks as jax_blocks
from repro.models import transformer as jax_transformer
from repro.models.factory import build_model as jax_build_model
from repro.plan import cost as jax_cost
from repro.plan import make_plan as jax_make_plan
from repro.plan import make_serve_plan as jax_make_serve_plan
from repro.serve import kv_cache as jax_kv_cache
from repro.serve import step as jax_serve_step
from repro.train import step as jax_train_step
from repro_torch import engine as torch_engine
from repro_torch.configs import registry
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.core import startrail as st
from repro_torch.dist import checkpoint
from repro_torch.dist.comm import ThreadMesh
from repro_torch.engine import sampling
from repro_torch.launch import serve
from repro_torch.models import blocks, transformer
from repro_torch.models.factory import (Model, build_model,
                                        from_jax_params, jax_tree,
                                        load_jax_tree, to_jax_layout)
from repro_torch.plan import cost, make_plan, make_serve_plan
from repro_torch.serve import step as serve_step
from repro_torch.train import step as train_step
from test_torch_plan import _clusters
from test_torch_train_sp import mesh_whole_grads

ARCH = "paligemma-3b"
SEQ, BATCH = 32, 2                       # spmd_vlm's shape
TOL = 2e-3                               # a loss or gradient (ROADMAP;
                                         # a leaf's, of its magnitude)
BLOCK_TOL = 2e-5                         # a block's output (ROADMAP)
RING_TOL = 2e-4                          # the JAX attention dist checks'
ISLAND = (2, 1, 2)                       # spmd_vlm's mesh (c, r, data)
RULE_SETS = ["default", "fsdp", "tp"]
REMATS = ["none", "attn_out", "full"]
PROMPT, GEN = 16, 5                      # the static-batch runs: prefix 2
FULL_PARAMS = 3_035_441_152
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


def _assert_scaled(got, want, what=""):
    """Within ``BLOCK_TOL`` of ``want``'s largest magnitude."""
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= BLOCK_TOL * max(float(np.abs(want).max()), 1.0), (what, err)


def _shard_order(batch, psp):
    """The batch with every leaf's sequence laid out in the SP shard order
    of ``psp`` zigzag ranks (``check_spmd_model``'s permutation)."""
    perm = jax_zz.make_positions(SEQ, psp, "zigzag").reshape(-1)
    return {k: np.take(v, perm, axis=1) for k, v in batch.items()}


def _jax_local_rt(model_j, seq=SEQ, kind="train"):
    return dataclasses.replace(jax_train_step.make_runtime(
        model_j, JaxRunConfig(c=1, seq_scheme="contiguous"),
        JaxShapeConfig("t", seq, BATCH, kind), mode="local"), batch_axes=())


def _patches(n=PROMPT):
    return torch.from_numpy(_ctx()["batch"]["frontend_emb"][:, :n].copy())


def _prompt(n=PROMPT):
    return torch.from_numpy(_ctx()["batch"]["tokens"][:, :n].astype(
        np.int64))


def _jax_legacy_steps(cfg, params, plan, tokens, patches, gen):
    """The JAX static-batch steps of ``_legacy_main`` with the given
    patches (its own feeds zeros) and at each step's true cache length: the
    prefill island, the prompt's K/V copied into a capacity-sized cache
    (padded to the SP multiple), then the decode island. Returns the
    tokens (B, gen) and the last cache's K and V (L, B, capacity, Hkv,
    hd)."""
    model = jax_build_model(cfg)
    mesh, run_cfg = plan.build_mesh(), plan.run_config()
    B, prompt_len = tokens.shape
    sp = plan.sp_size
    capacity = -(-(prompt_len + gen) // sp) * sp
    jprefill, _ = jax_serve_step.build_prefill_step(
        model, mesh, run_cfg, JaxShapeConfig("serve", prompt_len, B,
                                             "prefill"))
    tok, cache_p = jprefill(params, {
        "tokens": jnp.asarray(tokens, jnp.int32),
        "frontend_emb": jnp.asarray(patches, jnp.float32)})
    cache = jax.tree.map(np.array, jax_kv_cache.init_cache(cfg, B,
                                                           capacity))
    for sub, leaves in cache["stack"].items():
        for n, leaf in leaves.items():
            leaf[:, :, :prompt_len] = np.asarray(cache_p["stack"][sub][n])
    _, info = jax_serve_step.build_decode_step(
        model, mesh, run_cfg, JaxShapeConfig("serve", capacity, B,
                                             "decode"))
    decode = jax.jit(jax.shard_map(
        lambda p, c, t, cl: jax_serve_step.lm_decode_step(
            info["rt"], p, c, t, cfg, cl),
        mesh=mesh, in_specs=(info["param_specs"], info["cache_specs"],
                             info["tok_spec"], P(info["tok_spec"][0])),
        out_specs=(info["tok_spec"], info["cache_specs"]), check_vma=False))
    out = [np.asarray(tok)]
    for i in range(gen - 1):
        tok, cache = decode(params, cache, tok,
                            np.full((B,), prompt_len + i, np.int32))
        out.append(np.asarray(tok))
    kv = cache["stack"]["sub0"]
    return (np.concatenate(out, axis=1), np.asarray(kv["k"]),
            np.asarray(kv["v"]))


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
    batch_s = _shard_order(ctx["batch"], c * c * r)
    for rules in RULE_SETS:
        fn, _ = jax_train_step.build_value_and_grad_fn(
            model, mesh, JaxRunConfig(c=c, seq_scheme="zigzag",
                                      sharding_rules=rules), shape)
        loss, grads = jax.jit(fn)(params, batch_s)
        out[f"{rules}|loss"] = np.asarray(loss, np.float32)
        for path, g in jax.tree_util.tree_leaves_with_path(grads):
            out[f"{rules}|{jax.tree_util.keystr(path)}"] = \
                np.asarray(g, np.float32)

    # the prefill island with patches, on the (2, 1, 2) mesh
    jprefill, _ = jax_serve_step.build_prefill_step(
        model, mesh, JaxRunConfig(c=c, seq_scheme="contiguous"),
        JaxShapeConfig("t", SEQ, BATCH, "prefill"))
    tok, cache = jprefill(params, {k: ctx["batch"][k]
                                   for k in ("tokens", "frontend_emb")})
    out["prefill|tok"] = np.asarray(tok)
    for n in ("k", "v"):
        out[f"prefill|{n}"] = np.asarray(cache["stack"]["sub0"][n])

    # the static-batch steps at P = 4 (c 2, r 1)
    plan = jax_make_serve_plan(cfg, arch=ARCH, n_devices=4, c=2)
    assert (plan.sp_size, plan.c, plan.r) == (4, 2, 1)
    (out["legacy|4|tok"], out["legacy|4|k"],
     out["legacy|4|v"]) = _jax_legacy_steps(
        cfg, params, plan, ctx["batch"]["tokens"][:, :PROMPT],
        ctx["batch"]["frontend_emb"][:, :PROMPT], GEN)
    return out


_JAX_CHILD = r"""
import sys
import numpy as np
sys.path.insert(0, "tests")
from test_torch_vlm import jax_references
np.savez(sys.argv[1], **jax_references())
"""


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = tmp_path_factory.mktemp("vlm") / "references.npz"
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
    child process); the period is JAX's ``layer_pattern`` (attention, MLP)
    and the head size 256."""
    for cfg, cfg_j in ((registry.get(ARCH), jax_registry.get(ARCH)),
                       (registry.get_smoke(ARCH),
                        jax_registry.get_smoke(ARCH))):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
        assert cfg.family == "vlm" and cfg.frontend_stub == "patch"
        assert transformer.layer_pattern(cfg) == \
            jax_transformer.layer_pattern(cfg_j) == [("attn", "mlp")]
    full = registry.get(ARCH)
    assert (full.head_dim_, full.num_heads, full.num_kv_heads) == (256, 8, 1)
    assert not full.tie_embeddings and full.prefix_len_frac == 0.125


def test_specs_and_parameter_count_equal_jax():
    """Every leaf's shape and logical axes against JAX's ``lm_specs`` (the
    port's per-layer leaves against a row of JAX's stacked ones, its
    ``lm_head`` untied); the full-width count: 3 035 441 152, JAX's."""
    for cfg, cfg_j in ((registry.get(ARCH), jax_registry.get(ARCH)),
                       (registry.get_smoke(ARCH),
                        jax_registry.get_smoke(ARCH))):
        model = _meta_model(cfg)
        specs_j = jax_transformer.lm_specs(cfg_j)
        axes = model.axes()
        for name, p in model.named_parameters():
            parts = name.split(".")
            if parts[0] == "layers":
                node = specs_j["stack"]["sub0"]
                for key in parts[2:]:
                    node = node[key]
                shape, ax = node.shape[1:], node.axes[1:]
            else:
                node = specs_j
                for key in parts:
                    node = node[key]
                shape, ax = node.shape, node.axes
            assert (tuple(p.shape), axes[name]) == (tuple(shape), ax), name
        assert model.param_count() == jax_build_model(cfg_j).param_count()
        assert hasattr(model, "lm_head")
    assert _meta_model(registry.get(ARCH)).param_count() == FULL_PARAMS


def test_jax_tree_and_checkpoint_round_trip(tmp_path):
    """``from_jax_params`` then ``to_jax_layout`` give JAX's tree back, path
    for path and bit for bit (the dense stack and the untied ``lm_head``);
    the port's tree saved in the JAX format restores in the JAX package
    and back into a port model."""
    from repro.dist import checkpoint as jax_ckpt

    ctx = _ctx()
    cfg = ctx["cfg"]
    model = from_jax_params(ctx["tree"], cfg, "cpu")
    back = to_jax_layout(dict(model.named_parameters()), cfg)
    want = jax.tree_util.tree_leaves_with_path(ctx["tree"])
    got = dict((jax.tree_util.keystr(p), g) for p, g in
               jax.tree_util.tree_leaves_with_path(back))
    assert sorted(got) == sorted(jax.tree_util.keystr(p) for p, _ in want)
    for p, w in want:
        np.testing.assert_array_equal(got[jax.tree_util.keystr(p)], w)
    assert sorted(ctx["tree"]) == ["embed", "final_norm", "lm_head", "stack"]

    model = build_model(cfg, "cpu", seed=4)
    tree = jax_tree(dict(model.named_parameters()), cfg)
    checkpoint.save(tmp_path, 3, tree)
    restored = jax_ckpt.restore(tmp_path, 3, ctx["tree"])
    for a, b in zip(jax.tree.leaves(restored), checkpoint.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jax_ckpt.save(tmp_path / "j", 4, restored)
    again = build_model(cfg, "cpu", seed=5)
    load_jax_tree(again, checkpoint.restore(tmp_path / "j", 4, tree))
    for (n, a), b in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(a, b), n


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


def _torch_batch(batch=None):
    return {k: torch.from_numpy(v) for k, v in
            (batch or _ctx()["batch"]).items()}


def _jax_local_loss_and_grads(batch, cfg_j=None):
    ctx = _ctx()
    model_j = jax_build_model(cfg_j) if cfg_j is not None \
        else ctx["model_j"]
    rt_j = jax_train_step.make_runtime(
        model_j, JaxRunConfig(c=1), JaxShapeConfig("test", SEQ, BATCH,
                                                   "train"), mode="local")
    loss_j, grads_j = jax.jit(jax.value_and_grad(lambda p: model_j.loss(
        rt_j, p, batch, remat="none")))(ctx["tree"])
    return loss_j, {jax.tree_util.keystr(p): np.asarray(g) for p, g in
                    jax.tree_util.tree_leaves_with_path(grads_j)}


def _port_loss_and_grads(model, batch, remat="attn_out"):
    vg, _ = train_step.build_value_and_grad_fn(
        model, RunConfig(c=1, remat=remat),
        ShapeConfig("test", SEQ, BATCH, "train"))
    return vg(_torch_batch(batch))


def test_loss_and_grads_match_jax_local_mode():
    """With patches, at P = 1 under each ``remat``, against
    ``jax.value_and_grad`` of the JAX local-mode loss; the loss within
    ``TOL``, every gradient leaf within ``TOL`` of its magnitude
    (``_leaf_errs``). The patches matter: the loss moves when they do."""
    ctx = _ctx()
    loss_j, flat = _jax_local_loss_and_grads(ctx["batch"])
    model = from_jax_params(ctx["tree"], ctx["cfg"], "cpu")
    for remat in REMATS:
        loss, grads = _port_loss_and_grads(model, ctx["batch"], remat)
        assert abs(float(loss) - float(loss_j)) < TOL, remat
        errs = _leaf_errs(model, grads, flat.get)
        assert len(errs) == len(flat) and max(errs.values()) < TOL, errs
        assert all(bool(torch.isfinite(g).all()) for g in grads)
    other = dict(ctx["batch"], frontend_emb=-ctx["batch"]["frontend_emb"])
    assert abs(float(_port_loss_and_grads(model, other)[0]) -
               float(loss_j)) > 10 * TOL


def test_loss_without_a_prefix_is_the_text_only_loss():
    """A batch without patches runs the text-only loss (JAX's too, within
    ``TOL``); a config whose prefix is 0 positions (``prefix_len_frac``
    0) takes the patches nowhere, masks no position out of the loss and
    sees no key through the prefix: its loss and gradients with patches
    equal the text-only ones."""
    ctx = _ctx()
    text = {k: ctx["batch"][k] for k in ("tokens", "labels")}
    loss_j, flat = _jax_local_loss_and_grads(text)
    model = from_jax_params(ctx["tree"], ctx["cfg"], "cpu")
    loss, grads = _port_loss_and_grads(model, text)
    assert abs(float(loss) - float(loss_j)) < TOL
    assert max(_leaf_errs(model, grads, flat.get).values()) < TOL
    zero = dataclasses.replace(ctx["cfg"], prefix_len_frac=0.0)
    model0 = from_jax_params(ctx["tree"], zero, "cpu")
    loss0, grads0 = _port_loss_and_grads(model0, ctx["batch"])
    assert torch.equal(loss0, loss)
    for a, b in zip(grads0, grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rules", RULE_SETS)
def test_loss_and_grads_match_the_jax_island(references, rules):
    """At ``spmd_vlm``'s mesh (c 2, r 1, data 2) on ``ThreadMesh`` ranks,
    zigzag layout, the batch and patches in the shard order, against the
    JAX spmd island under the same rule set; the loss within ``TOL`` (and
    of the JAX local mode's on the unpermuted batch), every gradient leaf
    within ``TOL`` of its magnitude."""
    want = references()
    ctx = _ctx()
    model = from_jax_params(ctx["tree"], ctx["cfg"], "cpu")
    c, r, data = ISLAND
    losses, grads = mesh_whole_grads(
        model, ThreadMesh(c, r, data),
        RunConfig(c=c, seq_scheme="zigzag", sharding_rules=rules),
        ShapeConfig("test", SEQ, BATCH, "train"),
        _torch_batch(_shard_order(ctx["batch"], c * c * r)))
    for loss in losses:
        assert abs(float(loss) - float(want[f"{rules}|loss"])) < TOL
    p1, _ = _port_loss_and_grads(model, ctx["batch"])
    assert abs(float(losses[0]) - float(p1)) < TOL
    errs = _leaf_errs(model, grads, lambda p: want[f"{rules}|{p}"])
    assert len(errs) == len(jax.tree.leaves(ctx["tree"]))
    assert max(errs.values()) < TOL, errs


def test_shard_batch_splits_the_patches_on_the_sequence_axis():
    """Each rank's ``frontend_emb`` is its data rows and its SP rank's
    columns, as JAX's spec ``P(b, seq, None)`` places them, and the rank's
    prefix positions are its zigzag positions below ``prefix_len``."""
    batch = _torch_batch()
    model = build_model(_ctx()["cfg"], "cpu", seed=0)
    c, r, data = ISLAND

    def rank_fn(comm):
        rt = train_step.make_runtime(model, RunConfig(c=c),
                                     ShapeConfig("t", SEQ, BATCH, "train"),
                                     comm)
        x = torch.zeros((BATCH // data, SEQ // (c * c * r), 64))
        emb = torch.ones_like(x)
        _, prefix_len, is_prefix = transformer.patch_prefix(rt, x, emb,
                                                            model.cfg)
        return (comm.axis_index("data"), rt.sp_rank(),
                train_step.shard_batch(batch, rt), prefix_len,
                is_prefix, rt.positions(x.shape[1]))

    n = SEQ // (c * c * r)
    rows = BATCH // data
    for d, q, got, prefix_len, is_prefix, pos in \
            ThreadMesh(c, r, data).run(rank_fn):
        for k in ("frontend_emb", "tokens", "labels"):
            assert torch.equal(got[k], batch[k][d * rows:(d + 1) * rows,
                                                q * n:(q + 1) * n]), k
        assert prefix_len == 4
        assert torch.equal(is_prefix, pos < 4)


# ---------------------------------------------------------------------------
# StarTrail under the prefix-LM mask
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c,r,prefix_len", [(2, 1, 10), (2, 2, 20),
                                            (1, 8, 37)])
def test_startrail_with_a_prefix_matches_jax_grad(c, r, prefix_len):
    """Forward and backward of every rank (zigzag, the prefix over several
    ranks' shards, ``block_skip`` on, 4 query heads on one kv head) against
    ``mha_reference(prefix_len=)`` and ``jax.grad`` of ``sum(o * do)``,
    within ``RING_TOL``."""
    n, d, hq, hkv, b = 64, 8, 4, 1, 2
    rng = np.random.default_rng(11)
    q, k, v, do = (rng.normal(size=(b, n, h, d)).astype(np.float32)
                   for h in (hq, hkv, hkv, hq))
    mesh = ThreadMesh(c, r)
    p = mesh.size
    cfg = st.StarTrailConfig(seq_len=n, seq_scheme="zigzag",
                             prefix_len=prefix_len, block_impl="cuda",
                             block_skip=True)

    def rank_fn(comm):
        g, j, t = (comm.axis_index(a) for a in cfg.axes)
        pos = st.shard_positions((g * r + j) * c + t, n, p,
                                 "zigzag").numpy()
        shard = [torch.from_numpy(np.ascontiguousarray(x[:, pos]))
                 for x in (q, k, v, do)]
        o, res = st.startrail_forward(*shard[:3], cfg, comm)
        return pos, o, st.startrail_backward(res, o, shard[3], cfg, comm)

    out = np.zeros_like(q)
    grads = [np.zeros_like(x) for x in (q, k, v)]
    for pos, o, gs in mesh.run(rank_fn, timeout=120):
        out[:, pos] = o.numpy()
        for full, gr in zip(grads, gs):
            full[:, pos] = gr.numpy()

    def loss(q, k, v):
        o = jax_ref.mha_reference(q, k, v, prefix_len=prefix_len)
        return (o * do).sum()

    args = tuple(jnp.asarray(x) for x in (q, k, v))
    want = jax_ref.mha_reference(*args, prefix_len=prefix_len)
    np.testing.assert_allclose(out, np.asarray(want), atol=RING_TOL,
                               rtol=RING_TOL)
    for label, got, g in zip(("dq", "dk", "dv"), grads,
                             jax.grad(loss, argnums=(0, 1, 2))(*args)):
        np.testing.assert_allclose(got, np.asarray(g), atol=RING_TOL,
                                   rtol=RING_TOL, err_msg=label)


@pytest.mark.parametrize("p", [4, 8])
def test_fully_masked_skips_the_steps_jax_skips(p):
    """Over every (query shard, key shard) pair of ``p`` ranks, zigzag and
    contiguous, causal with and without a window, the port's
    ``fully_masked`` is JAX's ``_fully_masked`` (``startrail.py:162-175``)
    under prefixes of 0, 5, 20 and 40 of 64 positions; a prefix keeps live
    a step the causal mask alone would skip."""
    n = 64
    revived = 0
    for scheme in ("zigzag", "contiguous"):
        pos = [st.shard_positions(i, n, p, scheme) for i in range(p)]
        for window in (None, 12):
            for prefix_len in (None, 0, 5, 20, 40):
                cfg = st.StarTrailConfig(seq_len=n, seq_scheme=scheme,
                                         window=window,
                                         prefix_len=prefix_len)
                cfg_j = jax_st.StarTrailConfig(seq_len=n, seq_scheme=scheme,
                                               window=window,
                                               prefix_len=prefix_len)
                bare = dataclasses.replace(cfg, prefix_len=None)
                for a in pos:
                    for b in pos:
                        got = st.fully_masked(cfg, a, b)
                        want = bool(jax_st._fully_masked(
                            cfg_j, jnp.asarray(a.numpy()),
                            jnp.asarray(b.numpy())))
                        assert got == want, (scheme, window, prefix_len)
                        revived += st.fully_masked(bare, a, b) and not got
    assert revived > 0


# ---------------------------------------------------------------------------
# serving: the prefill with patches and the decode steps after it
# ---------------------------------------------------------------------------

def test_lm_prefill_matches_jax(references):
    """At P = 1 against JAX's ``lm_prefill`` in local mode with the same
    patches, and on every rank of the (2, 1, 2) mesh (its rows and its
    contiguous slice of tokens and patches) against the JAX
    ``build_prefill_step`` island: tokens equal, every layer's K and V
    within ``BLOCK_TOL`` of the largest magnitude. The patches reach the
    cache: other patches give other K."""
    want = references()
    ctx = _ctx()
    cfg_j = ctx["cfg_j"]
    params = jax.tree.map(jnp.asarray, ctx["tree"])
    batch = {k: ctx["batch"][k] for k in ("tokens", "frontend_emb")}
    rt_j = _jax_local_rt(ctx["model_j"], kind="prefill")
    tok_j, cache_j = jax.jit(lambda p_, b: jax_serve_step.lm_prefill(
        rt_j, p_, b, cfg_j))(params, batch)
    model = from_jax_params(ctx["tree"], ctx["cfg"], "cpu")
    shape = ShapeConfig("t", SEQ, BATCH, "prefill")
    tokens = torch.from_numpy(batch["tokens"].astype(np.int64))
    patches = torch.from_numpy(batch["frontend_emb"])
    tok, caches = serve_step.build_prefill_step(
        model, RunConfig(c=1, seq_scheme="contiguous"), shape)(tokens,
                                                                patches)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_j))
    for n in ("k", "v"):
        _assert_scaled(caches[0][n].numpy(), cache_j["stack"]["sub0"][n],
                       ("p1", n))
    np.testing.assert_array_equal(want["prefill|tok"], np.asarray(tok_j))
    _, other = serve_step.build_prefill_step(
        model, RunConfig(c=1, seq_scheme="contiguous"), shape)(tokens,
                                                                -patches)
    assert not torch.allclose(other[0]["k"], caches[0]["k"])

    c, r, data = ISLAND
    fn = serve_step.build_prefill_step(
        model, RunConfig(c=c, seq_scheme="contiguous"), shape,
        ThreadMesh(c, r, data))
    tok, caches = fn(tokens, patches)
    np.testing.assert_array_equal(tok.numpy(), want["prefill|tok"])
    rows, n_loc = BATCH // data, SEQ // (c * c * r)
    for rank, (d, sp) in enumerate(fn.steps.where):
        for n in ("k", "v"):
            _assert_scaled(
                caches[rank][n].numpy(),
                want[f"prefill|{n}"][:, d * rows:(d + 1) * rows,
                                     sp * n_loc:(sp + 1) * n_loc],
                (rank, n))


@pytest.mark.parametrize("n_devices", [1, 4])
def test_legacy_steps_match_jax_at_true_cache_lengths(references, n_devices):
    """The static-batch path with patches (a prompt of 16: a prefix of 2)
    then ``GEN - 1`` decode steps at each step's true ``cache_len``, no
    prefix in the steps, at P = 1 (in process) and P = 4 (c 2, r 1; the
    child process's islands): the JAX steps' tokens, and the last caches
    (the ranks' slices joined) within ``BLOCK_TOL`` of JAX's K and V."""
    ctx = _ctx()
    cfg_j = ctx["cfg_j"]
    if n_devices == 1:
        plan_j = jax_make_serve_plan(cfg_j, arch=ARCH, n_devices=1, c=1)
        want = _jax_legacy_steps(
            cfg_j, jax.tree.map(jnp.asarray, ctx["tree"]), plan_j,
            ctx["batch"]["tokens"][:, :PROMPT],
            ctx["batch"]["frontend_emb"][:, :PROMPT], GEN)
    else:
        want = tuple(references()[f"legacy|4|{n}"] for n in ("tok", "k",
                                                             "v"))
    model = from_jax_params(ctx["tree"], ctx["cfg"], "cpu")
    plan = make_serve_plan(model.cfg, arch=ARCH, n_devices=n_devices,
                           c=2 if n_devices > 1 else 1)
    assert plan.sp_size == n_devices
    got = serve.legacy_generate(model, plan, _prompt(), GEN,
                                patches=_patches())
    assert got.shape == (BATCH, GEN)
    np.testing.assert_array_equal(got.numpy(), want[0])
    tok, caches, decode = serve.legacy_start(model, plan, _prompt(), GEN,
                                             patches=_patches())
    for i in range(GEN - 1):
        tok = decode(caches, tok.long(), torch.full(
            (BATCH,), PROMPT + i, dtype=torch.int32))
    ranks = decode.steps.groups()[0]
    for i, n in enumerate(("k", "v")):
        whole = torch.cat([caches[r][n] for r in ranks], dim=2)
        assert whole.shape == want[1 + i].shape
        _assert_scaled(whole.numpy(), want[1 + i], (n_devices, n))


def _full_argmax(model, tokens, patches, prefix_len):
    """The port's full forward at P = 1 over ``tokens`` with the patches at
    the positions below ``prefix_len`` (the prompt's prefix, not one
    derived from this sequence's length) -> the argmax of its logits at
    every position."""
    cfg = model.cfg
    S = tokens.shape[1]
    plan = make_plan(cfg, ShapeConfig("t", S, BATCH, "prefill"), n_devices=1)
    rt = train_step.make_runtime(model, plan.run_config(),
                                 plan.shape_config())
    rt = dataclasses.replace(rt, st_cfg=dataclasses.replace(
        rt.st_cfg, seq_scheme="contiguous"))
    is_prefix = torch.arange(S) < prefix_len
    with torch.no_grad():
        x = blocks.embed(rt, model.embed, tokens, cfg)
        x = torch.where(is_prefix[None, :, None],
                        patches[:, :S].to(x.dtype), x)
        x, _ = transformer.apply_stack(rt, model.layers, x, cfg,
                                       prefix_len=prefix_len)
        x = blocks.rmsnorm(model.final_norm, x, cfg.norm_eps)
        logits = torch.stack([sampling.shard_logits(
            rt, model.head, x[:, s:s + 1], cfg)[0] for s in range(S)], 1)
    return logits.reshape(tokens.shape[0], S, -1).argmax(-1)


@pytest.mark.parametrize("n_devices", [1, 4])
def test_teacher_forced_decode_equals_the_full_forward_argmax(n_devices):
    """The prompt (16 tokens, its patches) prefilled, then the rest of the
    32 tokens fed through decode steps one at a time, each at its own
    position: the prefill's token and every step's are the argmax of the
    full forward over all 32 tokens at the *prompt's* ``prefix_len`` (2;
    JAX derives the prefix from the sequence length, so a forward over 32
    tokens would move it to 4), at P = 1 and P = 4 (c 2)."""
    ctx = _ctx()
    cfg = ctx["cfg"]
    model = from_jax_params(ctx["tree"], cfg, "cpu")
    tokens = _prompt(SEQ)
    patches = _patches(SEQ)
    prefix_len = int(cfg.prefix_len_frac * PROMPT)
    assert prefix_len == 2
    want = _full_argmax(model, tokens, patches, prefix_len)
    moved = _full_argmax(model, tokens, patches, 4)
    assert not torch.equal(want[:, PROMPT - 1:], moved[:, PROMPT - 1:])
    plan = make_serve_plan(cfg, arch=ARCH, n_devices=n_devices,
                           c=2 if n_devices > 1 else 1)
    tok, caches, decode = serve.legacy_start(
        model, plan, tokens[:, :PROMPT], SEQ - PROMPT,
        patches=patches[:, :PROMPT])
    got = [tok]
    for t in range(PROMPT, SEQ):
        got.append(decode(caches, tokens[:, t:t + 1],
                          torch.full((BATCH,), t, dtype=torch.int32)))
    got = torch.cat(got, 1)
    np.testing.assert_array_equal(got.numpy(),
                                  want[:, PROMPT - 1:].numpy())


def test_jax_zero_patches_keep_the_prefix_rows_zero():
    """The reference behaviour of ``repro/launch/serve.py:91-94``, pinned:
    JAX's ``--legacy`` feeds zero patches, so the prefix rows normalise to
    zero, their queries, keys and values are zero, a prefix query sees only
    prefix keys, and the rows stay exactly zero after every layer: the
    bidirectional prefix then carries nothing, and a wrong prefix mask
    would not show. The port's seeded patches leave no prefix row zero."""
    ctx = _ctx()
    cfg_j = ctx["cfg_j"]
    params = jax.tree.map(jnp.asarray, ctx["tree"])
    rt_j = _jax_local_rt(ctx["model_j"], seq=PROMPT, kind="prefill")
    prefix_len = int(cfg_j.prefix_len_frac * PROMPT)
    tokens = jnp.asarray(ctx["batch"]["tokens"][:, :PROMPT])

    def layers(emb):
        x = jax_blocks.embed(rt_j, params["embed"], tokens, cfg_j)
        is_prefix = (jnp.arange(PROMPT) < prefix_len)[None, :, None]
        x = jnp.where(is_prefix, emb, x)
        out = []
        for i in range(cfg_j.num_layers):
            p = jax.tree.map(lambda a: a[i], params["stack"]["sub0"])
            x = jax_blocks.attention_block(rt_j, p["mixer"], x, cfg_j,
                                           prefix_len=prefix_len)
            x = jax_blocks.mlp_block(rt_j, p["mlp"], x, cfg_j)
            out.append(np.asarray(x[:, :prefix_len]))
        return out

    zeros = jnp.zeros((BATCH, PROMPT, cfg_j.d_model), jnp.float32)
    assert all(not rows.any() for rows in layers(zeros))
    seeded = layers(jnp.asarray(_patches().numpy()))
    assert all(float(np.abs(rows).min(axis=-1).min()) > 0
               for rows in seeded)

    model = from_jax_params(ctx["tree"], ctx["cfg"], "cpu")
    rt = serve_step.StaticSteps(model, RunConfig(c=1), ShapeConfig(
        "t", PROMPT, BATCH, "prefill")).rt
    with torch.no_grad():
        x = blocks.embed(rt, model.embed, _prompt(), model.cfg)
        x, pl, _ = transformer.patch_prefix(rt, x, _patches(), model.cfg)
        assert pl == prefix_len
        for i, layer in enumerate(model.layers):
            x = blocks.attention_block(rt, layer.mixer, x, model.cfg,
                                       prefix_len=pl)
            x = blocks.mlp_block(rt, layer.mlp, x, model.cfg)
            _assert_scaled(x[:, :pl].numpy(), seeded[i], ("layer", i))


# ---------------------------------------------------------------------------
# the launchers, the refusals and the plan
# ---------------------------------------------------------------------------

def test_engine_gateway_and_launcher_refuse_the_vlm():
    """The JAX engine's reason, from the engine, the gateway, and
    ``launch.serve`` without ``--legacy`` (engine mode and ``--http``)."""
    from repro_torch.gateway import build_gateway

    ok, why = jax_paged_cache.supported(jax_registry.get_smoke(ARCH))
    assert not ok and "frontend" in why
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


@pytest.mark.parametrize("n_devices", [1, 4])
def test_launch_serve_legacy_draws_seeded_patches(n_devices, capsys):
    """``launch.serve --legacy`` at P = 1 and 4: its tokens are
    ``legacy_generate``'s on the seeded model, prompt and patches
    (``--seed``), not on zero patches."""
    import numpy.random as npr

    seed, batch, gen = 3, 2, 4
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--legacy", "--devices", str(n_devices), "--c",
                      "2" if n_devices > 1 else "1", "--batch", str(batch),
                      "--prompt-len", str(PROMPT), "--gen", str(gen),
                      "--seed", str(seed)])
    assert f"P_sp={n_devices}" in capsys.readouterr().out
    cfg = registry.get_smoke(ARCH)
    model = build_model(cfg, "cpu", seed=seed)
    tokens = torch.from_numpy(npr.default_rng(seed + 1).integers(
        0, cfg.vocab_size, (batch, PROMPT)))
    patches = torch.from_numpy(npr.default_rng(seed).standard_normal(
        (batch, PROMPT, cfg.d_model), dtype=np.float32))
    plan = make_serve_plan(cfg, arch=ARCH, n_devices=n_devices,
                           c=2 if n_devices > 1 else 1)
    want = serve.legacy_generate(model, plan, tokens, gen, patches=patches)
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    zero = serve.legacy_generate(model, plan, tokens, gen,
                                 patches=torch.zeros_like(patches))
    assert not torch.equal(zero, want)


def test_launch_train_on_eight_ranks_saves_and_resumes(tmp_path, capsys):
    """``launch.train`` on 8 ranks (data 2, c 2) from the pipeline's
    patches: finite losses; a JAX-format checkpoint that a rerun with more
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


def test_plan_refuses_ulysses_as_jax_does():
    """One kv head: no SP degree above 1 divides it, so ``make_plan``
    refuses ``scheme='ulysses'`` in both packages, and the launcher
    before any rank starts; StarTrail is the plan either leaves it."""
    from repro_torch.launch import train

    cfg, cfg_j = registry.get_smoke(ARCH), jax_registry.get_smoke(ARCH)
    shape = ShapeConfig("t", SEQ, BATCH, "train")
    shape_j = JaxShapeConfig("t", SEQ, BATCH, "train")
    for n in (2, 4, 8):
        with pytest.raises(ValueError, match="Ulysses"):
            make_plan(cfg, shape, n_devices=n, c=1, scheme="ulysses")
        with pytest.raises(ValueError, match="Ulysses|ulysses"):
            jax_make_plan(cfg_j, shape_j, n_devices=n, c=1,
                          scheme="ulysses")
    assert make_plan(cfg, shape, n_devices=4).scheme == \
        jax_make_plan(cfg_j, shape_j, n_devices=4).scheme == "startrail"
    with pytest.raises(ValueError, match="Ulysses"):
        train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--devices", "4", "--scheme", "ulysses", "--steps",
                    "1"])


def test_plan_costs_equal_jax():
    """``plan/cost.py`` on the port's own paligemma config (not prefix-LM
    causal: ``prefix_len_frac`` > 0) against the JAX one's, at the
    training shape, every arrangement at P = 1 to 8, under an equal
    explicit ``ClusterModel`` (the JAX constants, as ``test_torch_plan``)."""
    cfg, cfg_j = registry.get(ARCH), jax_registry.get(ARCH)
    shape = ShapeConfig("train_4k", 4096, 8, "train")
    shape_j = JaxShapeConfig("train_4k", 4096, 8, "train")
    for sp in (1, 2, 4, 8):
        cl, cl_j = _clusters(sp)
        arrs = cost.enumerate_arrangements(cfg, sp)
        arrs_j = jax_cost.enumerate_arrangements(cfg_j, sp)
        assert len(arrs) == len(arrs_j) > 0
        for a, a_j in zip(arrs, arrs_j):
            assert a.key == a_j.key
            got = cost.arrangement_time(cfg, shape, sp, a, cluster=cl)
            want = jax_cost.arrangement_time(cfg_j, shape_j, sp, a_j,
                                             cluster=cl_j)
            assert got == pytest.approx(want, rel=1e-12), (sp, a.key)
