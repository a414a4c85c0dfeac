"""repro_torch's sharding rules (``dist.sharding``) and its sharded
parameter, gradient and optimizer storage on a ThreadMesh, against the JAX
package.

* ``RULES`` and ``fsdp_logical`` equal the JAX tables; every leaf's layout
  equals the entries of the JAX ``partition_tree`` PartitionSpec (less the
  stacked layer dim) under each rule set on the dense configs both
  packages have; sharded dims divide on the smoke and production mesh
  sizes of ``tests/test_dist_substrate.py``; a dim that does not divide
  raises, naming the leaf; a rule set reusing a mesh axis raises as JAX's.
* Loss and every gradient leaf, assembled whole from the ranks' shards,
  under each rule set: against the JAX spmd island under the same rules at
  (c, r, data) = (2, 1, 2) (one child process with 8 forced host devices,
  started by the first test so it overlaps the rest), and against the JAX
  local mode at (1, 4, 2), (2, 2, 1) and P = 16 (4, 1, 1), within 2e-3
  (``check_spmd_model``'s bound).
* Every rank's gradient has its shard's shape, and ``reduce_leaf`` sums a
  leaf only over the mesh axes its layout does not mention: in values and
  in the communicator's ledger, alone and inside the step.
* Three train steps under ``tp`` at P = 8 against JAX ``build_train_step``
  under ``tp`` (the bounds of ``test_three_mesh_train_steps_match_jax``).
* ``int8``: a leaf's shards share the leaf's global per-tensor scale (bit
  for bit JAX's round trip of the whole leaf), and a mesh step at data 2
  against the JAX int8 step; ``microbatches=2`` equals 1 within 5e-5 under
  each rule set.
* A checkpoint written at (data 2, c 2) under ``fsdp`` restores at P = 1
  under ``default`` bit for bit (the JAX restore reads the same bits), and
  one more step there gives the loss of one more step on the mesh.
* The engine's ranks read their shards under the plan's rules: greedy
  streams at (c, r, data) = (2, 1, 2) equal the JAX engine's under 'fsdp'
  and 'tp' ('default' is ``tests/test_torch_engine_sp.py``'s).
* ``launch.train --rules tp`` trains on 8 ranks, ``--rules bogus`` is
  refused, and a JAX plan file with ``sharding_rules: "fsdp"`` loads.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_models as jax_paper_models
from repro.configs import registry as jax_registry
from repro.configs.base import RunConfig as JaxRunConfig
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.dist import checkpoint as jax_ckpt
from repro.dist import meshes as jax_meshes
from repro.dist import sharding as jax_sharding
from repro.models.factory import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro.optim import grad as jax_grad
from repro.plan import make_plan as jax_make_plan
from repro.train import step as jax_train_step
from repro_torch.configs import paper_models, registry
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.data import pipeline
from repro_torch.dist import sharding
from repro_torch.dist.comm import ThreadMesh
from repro_torch.models import factory, transformer
from repro_torch.models.factory import (Model, build_model, from_jax_params,
                                        shard_blocks, shard_params,
                                        to_jax_layout)
from repro_torch.optim import adamw
from repro_torch.optim import grad as grad_lib
from repro_torch.plan import ExecutionPlan, make_plan
from repro_torch.train import step as train_step
from repro_torch.train import trainer
from repro_torch import engine as torch_engine
from repro_torch.plan import make_serve_plan
from test_torch_engine_sp import ENG, _drive, _requests
from test_torch_engine_sp import _ctx as _engine_ctx
from test_torch_train_sp import (ADAM, ARCH, BATCH, SEQ, TOL, _ctx,
                                 _jax_value_and_grad, _max_errs, _rel_l2,
                                 _sharded, mesh_whole_grads)

RULE_SETS = sorted(sharding.RULES)
DENSE = ["h2o-danube-1.8b", "minitron-8b", "deepseek-7b", "stablelm-3b"]
MOE = ["phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b"]
PAPER = ["gpt-3b", "gpt-7b", "dit-1b"]
# the axis sizes of tests/test_dist_substrate.py's MESH_SIZES
MESH_SIZES = {
    "smoke_c2": {"data": 2, "sp_grp": 2, "sp_ring": 1, "sp_team": 2},
    "smoke_c1": {"data": 2, "sp_grp": 1, "sp_ring": 4, "sp_team": 1},
    "prod_c2": {"data": 16, "sp_grp": 2, "sp_ring": 4, "sp_team": 2},
}
ISLAND = (2, 1, 2)                      # (c, r, data) of the JAX islands
LOCAL_LAYOUTS = [(1, 4, 2), (2, 2, 1), (4, 1, 1)]


class _Coords:
    """A communicator's axis sizes and indices, without a mesh."""

    def __init__(self, sizes, index=None):
        self.sizes, self.index = sizes, index or {}

    def axis_size(self, axis):
        return self.sizes.get(axis, 1)

    def axis_index(self, axis):
        return self.index.get(axis, 0)


def _entries(spec):
    return [() if e is None else tuple(e) if isinstance(e, (tuple, list))
            else (e,) for e in spec]


def _configs(name, full=True):
    if name in PAPER:
        if full:
            return registry.paper_model(name), jax_registry.paper_model(name)
        return paper_models.smoke_config(), jax_paper_models.smoke_config()
    if full:
        return registry.get(name), jax_registry.get(name)
    return registry.get_smoke(name), jax_registry.get_smoke(name)


def _meta_model(cfg):
    """The port's model of ``cfg`` with no storage (layouts only)."""
    return Model(cfg, lambda s: torch.empty(s.shape, device="meta"))


# ---------------------------------------------------------------------------
# the JAX spmd islands, in one child process with 8 forced host devices
# ---------------------------------------------------------------------------

_JAX_ISLANDS = r"""
import sys
import jax, numpy as np
from repro.configs import registry
from repro.configs.base import RunConfig, ShapeConfig
from repro.dist import meshes
from repro.models.factory import build_model
from repro.train import step as train_step
sys.path.insert(0, "tests")
from test_torch_sharding import ARCH, BATCH, ISLAND, RULE_SETS, SEQ, _batch
c, r, data = ISLAND
model = build_model(registry.get_smoke(ARCH))
params = model.init(jax.random.PRNGKey(0))
shape = ShapeConfig("test", seq_len=SEQ, global_batch=BATCH, kind="train")
mesh = meshes.local_mesh_for_tests(c=c, r=r, data=data)
batch = _batch(c * c * r)
out = {}
for rules in RULE_SETS:
    fn, _ = train_step.build_value_and_grad_fn(
        model, mesh, RunConfig(c=c, seq_scheme="zigzag",
                               sharding_rules=rules), shape)
    loss, grads = jax.jit(fn)(params, batch)
    out[rules + "|loss"] = np.asarray(loss, np.float32)
    for path, g in jax.tree_util.tree_leaves_with_path(grads):
        out[rules + "|" + jax.tree_util.keystr(path)] = np.asarray(
            g, np.float32)
np.savez(sys.argv[1], **out)
"""


def _batch(sp):
    """The tests' global batch, its sequence in SP shard order (numpy)."""
    return {k: v.numpy() for k, v in _sharded(_ctx()["batch"], sp).items()}


@pytest.fixture(scope="module")
def islands(tmp_path_factory):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = tmp_path_factory.mktemp("islands") / "islands.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(root, "src"))
    proc = subprocess.Popen([sys.executable, "-c", _JAX_ISLANDS, str(path)],
                            cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        yield proc, path
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


# ---------------------------------------------------------------------------
# the rule tables and layouts
# ---------------------------------------------------------------------------

def test_rules_equal_jax(islands):
    """The tables field for field (this test also starts the islands)."""
    assert set(sharding.RULES) == set(jax_sharding.RULES)
    for name, table in sharding.RULES.items():
        assert table == jax_sharding.RULES[name], name
        assert sharding.fsdp_logical(name) == jax_sharding.fsdp_logical(name)
    assert sharding.SP_AXES == jax_sharding.SP_AXES


@pytest.mark.parametrize("rules", RULE_SETS)
@pytest.mark.parametrize("name", DENSE + MOE + PAPER)
def test_partition_tree_roundtrip(name, rules):
    """Every leaf's layout is the JAX PartitionSpec's entries, the stacked
    layer dim left out; its axes are the JAX leaf's, and no mesh axis is
    used twice in one layout."""
    cfg, cfg_j = _configs(name)
    model, model_j = _meta_model(cfg), jax_build_model(cfg_j)
    specs_j, axes_j = model_j.partition(rules), model_j.axes()
    layouts, axes = model.partition(rules), model.axes()
    assert set(layouts) == set(axes) == {n for n, _ in
                                         model.named_parameters()}
    n_sub = len(transformer.layer_pattern(cfg))
    for name_p, layout in layouts.items():
        path, period = factory._layer_path(name_p, n_sub)
        spec, ax = specs_j, axes_j
        for key in path:
            spec, ax = spec[key], ax[key]
        want, want_axes = _entries(spec), tuple(ax)
        if period is not None:
            want, want_axes = want[1:], want_axes[1:]
        assert list(layout) == want, (name, rules, name_p)
        assert axes[name_p] == want_axes, (name, name_p)
        used = [a for entry in layout for a in entry]
        assert len(used) == len(set(used))
    # 9 leaves a dense layer, one more a MoE layer (its router) and 4 more
    # with a shared expert, the table(s) and the final norm
    n_moe = transformer.layer_kinds(cfg).count("moe")
    shared = bool(cfg.moe and cfg.moe.shared_expert)
    assert len(layouts) == (9 * cfg.num_layers + (1 + 4 * shared) * n_moe
                            + 2 + (not cfg.tie_embeddings))


@pytest.mark.parametrize("rules", RULE_SETS)
@pytest.mark.parametrize("mesh_name", sorted(MESH_SIZES))
@pytest.mark.parametrize("name", DENSE + MOE + PAPER)
def test_partition_layout_divisible(name, mesh_name, rules):
    """Sharded dims divide on the meshes the JAX layout test runs (smoke
    configs on the smoke meshes, full configs on the production pod); the
    paper's three share one smoke config."""
    full = mesh_name.startswith("prod")
    cfg, _ = _configs(name, full)
    model = _meta_model(cfg)
    sizes = MESH_SIZES[mesh_name]
    last = {a: n - 1 for a, n in sizes.items()}
    for idx in ({}, last):
        blocks = shard_blocks(model, _Coords(sizes, idx), rules)
        layouts = model.partition(rules)
        for (n, p), block in zip(model.named_parameters(), blocks):
            for dim, b, axes in zip(p.shape, block, layouts[n]):
                shards = int(np.prod([sizes[a] for a in axes], initial=1))
                assert b.stop - b.start == dim // shards


def test_layout_that_does_not_divide_raises():
    model = build_model(registry.get_smoke(ARCH), "cpu")
    with pytest.raises(ValueError, match=r"embed\.table: dim of 256 does "
                                         r"not split over mesh axes"):
        shard_params(model, _Coords({"sp_ring": 3}), "default")


def test_fsdp_logical_subset_of_rules():
    for name, table in sharding.RULES.items():
        for ax in sharding.fsdp_logical(name):
            assert table.get(ax), (name, ax)


def test_partition_tree_rejects_axis_reuse():
    rules = {"embed": ("data",), "embed_out": ("data",)}
    with pytest.raises(ValueError) as e:
        sharding.spec_for_axes(("embed", "embed_out"), rules)
    with pytest.raises(ValueError) as e_j:
        jax_sharding.spec_for_axes(("embed", "embed_out"), rules)
    assert str(e.value) == str(e_j.value)
    with pytest.raises(ValueError, match="sharding_rules must be one of"):
        sharding.check_rules("bogus")


def test_shards_are_views_of_the_model():
    """A rank's leaves share the model's storage; at P = 1 they are the
    whole leaves."""
    model = build_model(registry.get_smoke(ARCH), "cpu")
    whole = shard_params(model, _Coords({}), "tp")
    for n, p in model.named_parameters():
        assert whole.named[n].shape == p.shape
        assert whole.named[n].data_ptr() == p.data_ptr()
    sizes = MESH_SIZES["smoke_c2"]
    tree = shard_params(model, _Coords(sizes, {"sp_team": 1}), "tp",
                        trainable=True)
    wq = tree.layers[0].mixer.wq
    assert wq.requires_grad and wq.is_leaf
    assert wq.shape == (32, 2, 16)
    assert wq.data_ptr() == model.layers[0].mixer.wq[0:32, 2:4].data_ptr()
    assert tree.head is tree.lm_head and tree.embed.table.shape == (64, 32)


# ---------------------------------------------------------------------------
# values against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rules", RULE_SETS)
def test_loss_and_grads_match_jax_local_mode(rules):
    loss_j, grads_j = _jax_value_and_grad()
    model = from_jax_params(_ctx()["tree"], _ctx()["cfg"], "cpu")
    for c, r, data in LOCAL_LAYOUTS:
        losses, grads = mesh_whole_grads(
            model, ThreadMesh(c, r, data),
            RunConfig(c=c, seq_scheme="zigzag", remat="none",
                      sharding_rules=rules),
            ShapeConfig("test", SEQ, BATCH, "train"),
            _sharded(_ctx()["batch"], c * c * r))
        assert len(losses) == c * c * r * data
        assert abs(float(losses[0]) - float(loss_j)) < TOL, (c, r, data)
        worst = max(_max_errs(model, grads, grads_j), key=lambda kv: kv[1])
        assert np.isfinite(worst[1]) and worst[1] < TOL, (c, r, data, worst)


@pytest.mark.parametrize("rules", RULE_SETS)
def test_loss_and_grads_match_the_jax_island(islands, rules):
    proc, path = islands
    _, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr[-4000:]
    want = np.load(path)
    c, r, data = ISLAND
    model = from_jax_params(_ctx()["tree"], _ctx()["cfg"], "cpu")
    vg = train_step.build_mesh_value_and_grad_fn(
        model, RunConfig(c=c, seq_scheme="zigzag", sharding_rules=rules),
        ShapeConfig("test", SEQ, BATCH, "train"), ThreadMesh(c, r, data),
        timeout=120)
    loss, grads = vg(_sharded(_ctx()["batch"], c * c * r))
    assert abs(float(loss) - float(want[rules + "|loss"])) < TOL
    names = [n for n, _ in model.named_parameters()]
    got = jax.tree_util.tree_leaves_with_path(
        to_jax_layout(dict(zip(names, grads)), _ctx()["cfg"]))
    assert len(got) == 12
    for p, g in got:
        err = float(np.max(np.abs(g - want[rules + "|"
                                           + jax.tree_util.keystr(p)])))
        assert err < TOL, (rules, jax.tree_util.keystr(p), err)


# ---------------------------------------------------------------------------
# shard-sized gradients and the reduction over unmentioned axes
# ---------------------------------------------------------------------------

def _reduce_bytes(model, rules, sizes):
    """Per leaf: the f32 bytes ``reduce_leaf``'s all-reduce moves, 0 when
    every axis of more than one member is mentioned."""
    out = {}
    for n, p in model.named_parameters():
        layout = model.partition(rules)[n]
        sums = [a for a in sharding.MESH_AXES
                if a not in sharding.mentioned(layout) and sizes[a] > 1]
        numel = p.numel()
        for axes in layout:
            numel //= int(np.prod([sizes[a] for a in axes], initial=1))
        out[n] = 4 * numel if sums else 0
    return out


@pytest.mark.parametrize("rules", RULE_SETS)
def test_grads_are_shard_sized_and_reduced_over_unmentioned_axes(rules):
    """Every rank's gradient has its shard's shape (a whole-leaf gradient
    fails) and is contiguous; ``reduce_leaf`` on ones gives the unmentioned group's size over
    n_devices and moves exactly that group's f32 shard bytes."""
    c, r, data = 2, 1, 2
    model = from_jax_params(_ctx()["tree"], _ctx()["cfg"], "cpu")
    mesh = ThreadMesh(c, r, data)
    sizes = dict(mesh.shape)
    want_bytes = _reduce_bytes(model, rules, sizes)
    layouts = model.partition(rules)
    shape = ShapeConfig("test", SEQ, BATCH, "train")
    batch = _sharded(_ctx()["batch"], c * c * r)

    def rank_fn(comm):
        vg_fn, rt = train_step.build_value_and_grad_fn(
            model, RunConfig(c=c, remat="none", sharding_rules=rules), shape,
            comm)
        _, grads = vg_fn(train_step.shard_batch(batch, rt))
        assert all(g.is_contiguous() for g in grads)
        shapes = [tuple(g.shape) for g in grads]
        reduced = {}
        for n, p in model.named_parameters():
            before = comm.ledger.bytes["forward"]["all-reduce"]
            block = shard_blocks(model, comm, rules)[
                [m for m, _ in model.named_parameters()].index(n)]
            g = train_step.reduce_leaf(rt, torch.ones(p[block].shape),
                                       layouts[n], torch.float32)
            reduced[n] = (float(g.mean()), float(g.min()), float(g.max()),
                          comm.ledger.bytes["forward"]["all-reduce"]
                          - before)
        return shapes, shard_blocks(model, comm, rules), reduced

    out = mesh.run(rank_fn, timeout=120)
    params = dict(model.named_parameters())
    sharded = 0
    for shapes, blocks, reduced in out:
        for (n, p), s, block in zip(params.items(), shapes, blocks):
            assert s == tuple(p[block].shape), n
            sharded += s != tuple(p.shape)
        for n, (mean, lo, hi, nbytes) in reduced.items():
            group = int(np.prod([sizes[a] for a in sharding.MESH_AXES
                                 if a not in sharding.mentioned(layouts[n])]))
            assert mean == lo == hi == pytest.approx(group / mesh.size), n
            assert nbytes == want_bytes[n], n
    # at data 2 every leaf but the norms is split on every rank: the
    # tables, and per layer the MLP and the attention projections
    assert sharded == mesh.size * (2 + 2 * (3 + 4))


def test_step_reduction_bytes_follow_the_layouts():
    """Inside the step: the backward all-reduce bytes under 'tp' and under
    'default' differ by exactly the reduction bytes their layouts give (the
    model's own backward all-reduces are the same under both)."""
    c, r, data = 2, 1, 2
    model = from_jax_params(_ctx()["tree"], _ctx()["cfg"], "cpu")
    shape = ShapeConfig("test", SEQ, BATCH, "train")
    batch = _sharded(_ctx()["batch"], c * c * r)
    got = {}
    for rules in ("default", "tp"):
        mesh = ThreadMesh(c, r, data)
        train_step.build_mesh_value_and_grad_fn(
            model, RunConfig(c=c, remat="none", sharding_rules=rules),
            shape, mesh, timeout=120)(batch)
        got[rules] = mesh.ledgers[0].bytes["backward"]["all-reduce"]
    sizes = dict(ThreadMesh(c, r, data).shape)
    want = {rules: sum(_reduce_bytes(model, rules, sizes).values())
            for rules in ("default", "tp")}
    assert want["default"] > want["tp"] > 0
    assert got["default"] - got["tp"] == want["default"] - want["tp"]


# ---------------------------------------------------------------------------
# the train step under the rules
# ---------------------------------------------------------------------------

def _jax_step(rules="default", compression="none"):
    ctx = _ctx()
    shape_j = JaxShapeConfig("test", seq_len=SEQ, global_batch=BATCH,
                             kind="train")
    jstep, _ = jax_train_step.build_train_step(
        ctx["model_j"], jax_meshes.local_mesh_for_tests(c=1, r=1, data=1),
        JaxRunConfig(c=1, seq_scheme="zigzag", sharding_rules=rules,
                     grad_compression=compression), shape_j,
        jax_adamw.AdamWConfig(**ADAM))
    params_j = jax.tree.map(jnp.asarray, ctx["tree"])
    return jstep, params_j, jax_adamw.init_state(
        params_j, jax_adamw.AdamWConfig(**ADAM))


def _steps_against_jax(steps, rules, compression="none", data=1):
    ctx = _ctx()
    cfg = ctx["cfg"]
    jstep, params_j, opt_j = _jax_step(rules, compression)
    model = from_jax_params(ctx["tree"], cfg, "cpu")
    plan = make_plan(cfg, ShapeConfig("test", SEQ, BATCH, "train"),
                     n_devices=8, data=data, c=2, sharding_rules=rules,
                     grad_compression=compression)
    step, sh = plan.build_train_step(model, adamw.AdamWConfig(**ADAM))
    opt = adamw.init_state(sh["params"], adamw.AdamWConfig(**ADAM))
    data_j = pipeline.SyntheticLM(cfg, plan.shape_config(), seed=3)
    data_t = pipeline.SyntheticLM(cfg, plan.shape_config(), seed=3,
                                  sp_size=plan.sp_size)
    for i in range(steps):
        params_j, opt_j, m_j = jstep(params_j, opt_j, data_j.get_batch(i))
        opt, m = step(opt, {k: torch.from_numpy(v)
                            for k, v in data_t.get_batch(i).items()})
        for key in ("loss", "grad_norm"):
            assert abs(float(m[key]) - float(m_j[key])) < TOL, (i, key)
    got = to_jax_layout(dict(zip(sh["names"], sh["params"])), cfg)
    rel = jax.tree.map(_rel_l2, got, jax.tree.map(np.asarray, params_j))
    worst = max(jax.tree_util.tree_leaves_with_path(rel),
                key=lambda kv: kv[1])
    assert worst[1] < 1e-3, worst
    assert opt["step"] == steps
    return opt, opt_j


def test_three_tp_train_steps_match_jax():
    _steps_against_jax(3, "tp")


def test_int8_shards_share_the_leaf_scale():
    """Each leaf cut into its unique blocks under 'default' at data 2,
    each block at its own magnitude: the round trip of the blocks is bit
    for bit JAX's round trip of the whole leaf."""
    model = build_model(registry.get_smoke(ARCH), "cpu")
    per_rank = ThreadMesh(2, 1, 2).run(
        lambda comm: shard_blocks(model, comm, "default"), timeout=60)
    rng = np.random.default_rng(5)
    for i, (n, p) in enumerate(model.named_parameters()):
        x = rng.normal(size=p.shape).astype(np.float32)
        blocks = {tuple((b.start, b.stop) for b in rank[i]): rank[i]
                  for rank in per_rank}
        for k, block in enumerate(blocks.values()):
            x[block] *= 10.0 ** k
        shards = [torch.from_numpy(x[block]) for block in blocks.values()]
        got = grad_lib.int8_roundtrip(shards, [i] * len(shards))
        whole = np.empty_like(x)
        for block, g in zip(blocks.values(), got):
            whole[block] = g.numpy()
        want = np.asarray(jax_grad.int8_roundtrip(jnp.asarray(x)))
        assert np.array_equal(whole, want), n
        if len(blocks) > 1:
            own = grad_lib.int8_roundtrip(shards)
            assert not all(torch.equal(a, b) for a, b in zip(own, got)), n


def test_int8_mesh_step_at_data_2_matches_jax():
    _steps_against_jax(1, "default", compression="int8", data=2)


@pytest.mark.parametrize("rules", RULE_SETS)
def test_microbatch_equiv(rules):
    """Shard-sized f32 accumulators: 2 microbatches against 1 at (c, r,
    data) = (2, 1, 2), within 5e-5."""
    model = from_jax_params(_ctx()["tree"], _ctx()["cfg"], "cpu")
    batch = _sharded(_ctx()["batch"], 4)
    batch = {k: torch.cat([v, v.flip(1)]) for k, v in batch.items()}
    shape = ShapeConfig("test", SEQ, 2 * BATCH, "train")
    (l1, g1), (l2, g2) = (
        mesh_whole_grads(model, ThreadMesh(2, 1, 2),
                         RunConfig(c=2, microbatches=m,
                                   sharding_rules=rules), shape, batch)
        for m in (1, 2))
    assert abs(float(l1[0]) - float(l2[0])) < 5e-5
    assert max(float((a - b).abs().max()) for a, b in zip(g1, g2)) < 5e-5


# ---------------------------------------------------------------------------
# checkpoints across layouts
# ---------------------------------------------------------------------------

def _train(model, plan, ckpt, steps):
    return trainer.train(model, plan, adamw.AdamWConfig(**ADAM),
                         trainer.TrainerConfig(num_steps=steps, ckpt_every=2,
                                               ckpt_dir=str(ckpt),
                                               log_every=10, seed=4),
                         device="cpu")


def test_checkpoint_across_layouts(tmp_path):
    ctx = _ctx()
    cfg = ctx["cfg"]
    shape = ShapeConfig("test", SEQ, BATCH, "train")
    mesh_plan = make_plan(cfg, shape, n_devices=8, data=2, c=2,
                          sharding_rules="fsdp")
    model = from_jax_params(ctx["tree"], cfg, "cpu")
    _train(model, mesh_plan, tmp_path, 2)

    # restore at P = 1 under 'default': the trained parameters, and the
    # moments the JAX restore reads, bit for bit
    p1_plan = make_plan(cfg, shape, n_devices=1)
    assert p1_plan.sharding_rules == "default"
    other = build_model(cfg, "cpu", seed=9)
    _, sh = p1_plan.build_train_step(other, adamw.AdamWConfig(**ADAM))
    opt = adamw.init_state(sh["params"], adamw.AdamWConfig(**ADAM))
    assert trainer.restore_latest(tmp_path, other, sh["names"], opt) == 2
    for (n, a), b in zip(model.named_parameters(), other.parameters()):
        assert torch.equal(a, b), n
    params_j = jax.tree.map(jnp.asarray, ctx["tree"])
    got_j = jax_ckpt.restore(tmp_path, 2, jax.tree.map(np.asarray, params_j))
    got_opt = jax_ckpt.restore(tmp_path / "opt", 2, jax_adamw.init_state(
        params_j, jax_adamw.AdamWConfig(**ADAM)))
    assert int(got_opt["step"]) == opt["step"] == 2
    names = [n for n, _ in other.named_parameters()]
    for key in ("mu", "nu"):
        mine = to_jax_layout(dict(zip(names, opt[key])), cfg)
        for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(got_opt[key])):
            assert np.array_equal(a, np.asarray(b))
    for a, b in zip(jax.tree.leaves(to_jax_layout(
            dict(other.named_parameters()), cfg)), jax.tree.leaves(got_j)):
        assert np.array_equal(a, np.asarray(b))

    # one more step, restored on the mesh and at P = 1
    m_mesh = _train(from_jax_params(ctx["tree"], cfg, "cpu"), mesh_plan,
                    tmp_path, 3)
    m_p1 = _train(build_model(cfg, "cpu", seed=9), p1_plan, tmp_path, 3)
    assert m_mesh["step"] == m_p1["step"] == 3
    for key in ("loss", "grad_norm"):
        assert abs(m_mesh[key] - m_p1[key]) < TOL, key


# ---------------------------------------------------------------------------
# serving, plans and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rules", ["fsdp", "tp"])   # 'default': engine_sp
def test_engine_streams_under_each_rule_set(rules):
    ctx = _engine_ctx(ARCH)
    cfg = ctx["model"].cfg
    plan = make_serve_plan(cfg, arch=ARCH, n_devices=8, data=2, c=2,
                           decode_batch=ENG["max_slots"],
                           page_size=ENG["page_size"],
                           max_len=ENG["max_len"], sharding_rules=rules)
    assert plan.run_config().sharding_rules == rules
    eng = torch_engine.Engine(ctx["model"], plan,
                              torch_engine.EngineConfig(**ENG))
    got = _drive(eng, _requests(cfg.vocab_size, torch_engine.Request))
    assert got == ctx["want"]["joined"]
    # rank 0 reads its shards: the ffn over the 4 SP ranks, embed over
    # data, and under 'tp' the heads over the team
    mixer, mlp = eng._params[0].layers[0].mixer, eng._params[0].layers[0].mlp
    assert mlp.w1.shape == (cfg.d_model // 2, cfg.d_ff // 4)
    assert mixer.wq.shape == (cfg.d_model // 2, cfg.num_heads
                              // (2 if rules == "tp" else 1), cfg.head_dim_)


def test_launch_train_rules(tmp_path, capsys):
    from repro_torch.launch import train

    metrics = tmp_path / "m.jsonl"
    out = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--devices", "8", "--data", "2", "--c", "2",
                      "--rules", "tp", "--steps", "3", "--metrics",
                      str(metrics)])
    assert "rules=tp" in capsys.readouterr().out
    losses = [json.loads(x)["loss"] for x in metrics.read_text().splitlines()]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] and out["step"] == 3
    with pytest.raises(SystemExit):
        train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--rules", "bogus"])


@pytest.mark.parametrize("rules", ["fsdp", "tp"])
def test_jax_plan_file_with_rules_loads(rules, tmp_path):
    plan_j = jax_make_plan(jax_registry.get_smoke(ARCH),
                           JaxShapeConfig("smoke", 64, 4, "train"), arch=ARCH,
                           n_devices=8, data=2, c=2, sharding_rules=rules)
    got = ExecutionPlan.load(plan_j.save(tmp_path / "PLAN_jax.json"))
    assert got.sharding_rules == rules
    assert got.run_config().sharding_rules == rules
    assert ExecutionPlan.from_dict(got.to_dict()) == got
    d = got.to_dict()
    d["sharding_rules"] = "bogus"
    with pytest.raises(ValueError, match="sharding_rules must be one of"):
        ExecutionPlan.from_dict(d)
