"""repro_torch's training at SP degree > 1 on a ThreadMesh vs the JAX
package.

The smoke h2o-danube-1.8b (f32, 2 layers, window 16) with the JAX weights
carried across by ``from_jax_params`` and the same numpy batch as
``tests/test_torch_train.py``. Every rank of a ``ThreadMesh(c, r, data)``
(threads of this process) runs ``Model.loss`` on its part of the batch under
autograd, through the differentiable collectives of ``dist.comm``.

* Loss and reduced gradients at the dist checks' layouts (c, r, data) =
  (2, 1, 2) (``spmd_dense_swa``), (1, 4, 2) (``spmd_dense_c1``) and (2, 2, 1)
  (P = 8, a team and a ring) against the JAX local mode's
  ``jax.value_and_grad(model.loss)``, within 2e-3 (``check_spmd_model``'s
  bound), each leaf assembled whole from the ranks' shards (``default``
  rules); every rank's loss, and every replica of a shard, the same bits.
* ``remat='attn_out'`` at (2, 2, 1) equals ``'none'`` within f32 rounding.
* ``microbatches=4`` against 1 at (2, 1, 2), f32, seq 64, batch 8, within
  5e-5 (``check_microbatch_equiv``).
* Three mesh train steps at (2, 2, 1) against three JAX one-device
  ``build_train_step`` steps (the bounds of
  ``test_three_train_steps_match_jax``), and ``check_spmd_train_step`` at
  (2, 1, 2): lr 1e-2, three steps, the loss falls.
* Each collective's backward is its transpose: <C(x), g> = <x, C*(g)>
  summed over ranks, in f64 (all_to_all's is all_to_all with split and
  concat swapped). ``pmax`` refuses an input that needs a
  gradient; a rank thread runs its backward itself (multithreading off);
  ranks in different collectives raise instead of exchanging tensors.
* ``dist.meshes.refine_grid`` and ``launch.mesh.refinable_grids`` against
  the JAX functions; ``ring_inner`` gives the values of ``team_inner``.
* ``launch.train --devices 8 --data 2 --c 2`` on the CPU: the loss falls.
"""

import dataclasses
import json
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.configs.base import RunConfig as JaxRunConfig
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.dist import meshes as jax_meshes
from repro.launch import mesh as jax_launch_mesh
from repro.models.factory import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro.train import step as jax_train_step
from repro_torch.configs import registry
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.data import pipeline
from repro_torch.dist import meshes
from repro_torch.dist.comm import ThreadMesh
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models.factory import (from_jax_params, shard_blocks,
                                        to_jax_layout)
from repro_torch.optim import adamw
from repro_torch.plan import make_plan
from repro_torch.train import step as train_step

ARCH = "h2o-danube-1.8b"
SEQ, BATCH = 32, 2
TOL = 2e-3
ADAM = dict(learning_rate=1e-3, warmup_steps=0)
LAYOUTS = [(2, 1, 2), (1, 4, 2), (2, 2, 1)]
_CTX = {}


def _ctx():
    if not _CTX:
        cfg_j = jax_registry.get_smoke(ARCH)
        model_j = jax_build_model(cfg_j)
        params_j = model_j.init(jax.random.PRNGKey(0))
        rng = np.random.default_rng(0)
        batch = {n: rng.integers(0, cfg_j.vocab_size, (BATCH, SEQ),
                                 dtype=np.int32)
                 for n in ("tokens", "labels")}
        _CTX.update(cfg=registry.get_smoke(ARCH), model_j=model_j,
                    tree=jax.tree.map(np.asarray, params_j), batch=batch)
    return _CTX


def _sharded(batch, sp):
    """The global batch with its sequence in SP shard order (zigzag)."""
    perm = pipeline.shard_permutation(batch["tokens"].shape[1], sp,
                                      "zigzag").reshape(-1)
    return {k: torch.from_numpy(np.take(v, perm, axis=1))
            for k, v in batch.items()}


def _mesh_vg(model, mesh, run_cfg, shape, batch):
    """Every rank's (loss, reduced grads) on ``mesh``, in thread order."""
    def rank_fn(comm):
        vg_fn, rt = train_step.build_value_and_grad_fn(model, run_cfg, shape,
                                                       comm)
        return vg_fn(train_step.shard_batch(batch, rt))

    return mesh.run(rank_fn, timeout=120)


def mesh_whole_grads(model, mesh, run_cfg, shape, batch):
    """(every rank's loss, every gradient leaf whole): each rank's reduced
    shard gradients (``build_value_and_grad_fn`` on the rank) put in their
    blocks; the replicas of a block must hold the same bits, and the
    blocks must cover every leaf."""
    def rank_fn(comm):
        vg_fn, rt = train_step.build_value_and_grad_fn(model, run_cfg, shape,
                                                       comm)
        loss, grads = vg_fn(train_step.shard_batch(batch, rt))
        return loss, grads, shard_blocks(model, comm, rt.rules)

    out = mesh.run(rank_fn, timeout=120)
    whole = [torch.full(p.shape, float("nan"), dtype=p.dtype)
             for p in model.parameters()]
    seen = {}
    for _, grads, blocks in out:
        for i, (g, block) in enumerate(zip(grads, blocks)):
            assert g.shape == whole[i][block].shape
            key = (i, tuple((b.start, b.stop) for b in block))
            if key in seen:
                assert torch.equal(seen[key], g), key
            else:
                seen[key] = g
                whole[i][block] = g
    assert all(not torch.isnan(w).any() for w in whole)
    return [loss for loss, _, _ in out], whole


def _jax_value_and_grad(remat="none"):
    ctx = _ctx()
    shape_j = JaxShapeConfig("test", seq_len=SEQ, global_batch=BATCH,
                             kind="train")
    rt_j = jax_train_step.make_runtime(
        ctx["model_j"], JaxRunConfig(c=1, seq_scheme="zigzag"), shape_j,
        mode="local")
    return jax.jit(jax.value_and_grad(lambda p: ctx["model_j"].loss(
        rt_j, p, ctx["batch"], remat=remat)))(ctx["tree"])


def _max_errs(model, grads, want):
    names = [n for n, _ in model.named_parameters()]
    got = to_jax_layout(dict(zip(names, grads)), _ctx()["cfg"])
    errs = jax.tree.map(
        lambda a, b: float(np.max(np.abs(a - np.asarray(b, np.float32)))),
        got, want)
    return jax.tree_util.tree_leaves_with_path(errs)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("c,r,data", LAYOUTS)
def test_loss_and_grads_match_jax_local_mode(c, r, data):
    ctx = _ctx()
    loss_j, grads_j = _jax_value_and_grad()
    model = from_jax_params(ctx["tree"], ctx["cfg"], "cpu")
    mesh = ThreadMesh(c, r, data)
    losses, grads = mesh_whole_grads(
        model, mesh, RunConfig(c=c, seq_scheme="zigzag", remat="none"),
        ShapeConfig("test", SEQ, BATCH, "train"),
        _sharded(ctx["batch"], c * c * r))
    assert len(losses) == 8
    assert abs(float(losses[0]) - float(loss_j)) < TOL
    leaves = _max_errs(model, grads, grads_j)
    assert len(leaves) == len(jax.tree.leaves(grads_j)) == 12
    worst = max(leaves, key=lambda kv: kv[1])
    assert np.isfinite(worst[1]) and worst[1] < TOL, worst
    # the mesh sums every group in one order: all ranks hold the same bits
    assert all(torch.equal(loss, losses[0]) for loss in losses[1:])


def test_remat_attn_out_matches_none_on_the_mesh():
    ctx = _ctx()
    model = from_jax_params(ctx["tree"], ctx["cfg"], "cpu")
    shape = ShapeConfig("test", SEQ, BATCH, "train")
    batch = _sharded(ctx["batch"], 8)
    (l0, g0), (l1, g1) = (
        _mesh_vg(model, ThreadMesh(2, 2), RunConfig(c=2, remat=remat),
                 shape, batch)[0] for remat in ("none", "attn_out"))
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_microbatch_equiv():
    """``check_microbatch_equiv``: f32, (c, r, data) = (2, 1, 2), seq 64,
    batch 8; 4 microbatches against 1 within 5e-5."""
    cfg = _ctx()["cfg"]
    assert cfg.param_dtype == "float32"
    model = from_jax_params(_ctx()["tree"], cfg, "cpu")
    shape = ShapeConfig("test", 64, 8, "train")
    rng = np.random.default_rng(1)
    batch = _sharded({n: rng.integers(0, cfg.vocab_size, (8, 64),
                                      dtype=np.int32)
                      for n in ("tokens", "labels")}, 4)
    mesh = ThreadMesh(2, 1, data=2)
    (l1, g1), (l4, g4) = (
        _mesh_vg(model, mesh, RunConfig(c=2, microbatches=m), shape,
                 batch)[0] for m in (1, 4))
    assert abs(float(l1) - float(l4)) < 5e-5
    worst = max(float((a - b).abs().max()) for a, b in zip(g1, g4))
    assert worst < 5e-5


def test_three_mesh_train_steps_match_jax():
    ctx = _ctx()
    model_j, cfg = ctx["model_j"], ctx["cfg"]
    shape_j = JaxShapeConfig("test", seq_len=SEQ, global_batch=BATCH,
                             kind="train")
    jstep, _ = jax_train_step.build_train_step(
        model_j, jax_meshes.local_mesh_for_tests(c=1, r=1, data=1),
        JaxRunConfig(c=1, seq_scheme="zigzag"), shape_j,
        jax_adamw.AdamWConfig(**ADAM))
    params_j = jax.tree.map(jnp.asarray, ctx["tree"])
    opt_j = jax_adamw.init_state(params_j, jax_adamw.AdamWConfig(**ADAM))

    model = from_jax_params(ctx["tree"], cfg, "cpu")
    plan = make_plan(cfg, ShapeConfig("test", SEQ, BATCH, "train"),
                     n_devices=8, c=2)
    assert (plan.sp_size, plan.r, plan.data) == (8, 2, 1)
    step, sh = plan.build_train_step(model, adamw.AdamWConfig(**ADAM))
    opt = adamw.init_state(sh["params"], adamw.AdamWConfig(**ADAM))
    # the same tokens: in natural order for JAX, in shard order for the mesh
    data_j = pipeline.SyntheticLM(cfg, plan.shape_config(), seed=3)
    data_t = pipeline.SyntheticLM(cfg, plan.shape_config(), seed=3,
                                  sp_size=8)
    for i in range(3):
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
    assert opt["step"] == 3


def test_spmd_train_step_loss_falls():
    """``check_spmd_train_step`` at (c, r, data) = (2, 1, 2): lr 1e-2,
    three steps on one batch, the loss finite and falling."""
    ctx = _ctx()
    model = from_jax_params(ctx["tree"], ctx["cfg"], "cpu")
    plan = make_plan(ctx["cfg"], ShapeConfig("test", SEQ, BATCH, "train"),
                     n_devices=8, data=2, c=2)
    assert (plan.sp_size, plan.r) == (4, 1)
    adam = adamw.AdamWConfig(learning_rate=1e-2, warmup_steps=0)
    step, sh = plan.build_train_step(model, adam)
    opt = adamw.init_state(sh["params"], adam)
    batch = _sharded(ctx["batch"], 4)
    losses = []
    for _ in range(3):
        opt, m = step(opt, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

# (name, call, input shape): every rank's input has the same shape
COLLECTIVES = {
    "all_gather": (lambda cm, x: cm.all_gather(x, "sp_team", 1), (2, 3, 4)),
    "all_gather_sp": (lambda cm, x: cm.all_gather(
        x, ("sp_grp", "sp_ring", "sp_team"), 0), (2, 3)),
    "psum_scatter": (lambda cm, x: cm.psum_scatter(x, "sp_team", 1),
                     (2, 6, 4)),
    "psum": (lambda cm, x: cm.psum(x, ("sp_ring", "sp_team")), (3, 5)),
    "psum_data": (lambda cm, x: cm.psum(x, "data"), (3, 5)),
    "all_to_all": (lambda cm, x: cm.all_to_all(
        x, ("sp_grp", "sp_ring", "sp_team"), 1, 0), (3, 16)),
    # ranks 3 and 6 receive nothing; ranks 5 and 7 send nothing
    "ppermute": (lambda cm, x: cm.ppermute(
        x, ("sp_grp", "sp_ring", "sp_team"),
        [(0, 1), (1, 2), (2, 0), (4, 5), (5, 4), (3, 7)]), (2, 4)),
}


@pytest.mark.parametrize("name", sorted(COLLECTIVES))
def test_collective_backward_is_its_transpose(name):
    call, shape = COLLECTIVES[name]
    mesh = ThreadMesh(2, 2, data=2 if name == "psum_data" else 1)

    def rank_fn(comm):
        rng = np.random.default_rng(comm.rank)
        x = torch.from_numpy(rng.normal(size=shape)).requires_grad_()
        y = call(comm, x)
        g = torch.from_numpy(rng.normal(size=tuple(y.shape)))
        (xg,) = torch.autograd.grad(y, x, g)
        return float((y.detach() * g).sum()), float((x.detach() * xg).sum())

    res = mesh.run(rank_fn, timeout=60)
    lhs, rhs = sum(a for a, _ in res), sum(b for _, b in res)
    assert abs(lhs - rhs) <= 1e-9 * max(abs(lhs), 1.0), (lhs, rhs)


def test_pmax_refuses_a_gradient_and_backward_stays_on_the_rank():
    def rank_fn(comm):
        assert not torch._C._is_multithreading_enabled()
        x = torch.ones(3, requires_grad=True)
        with pytest.raises(ValueError, match="pmax carries no gradient"):
            comm.pmax(x, "sp_ring")
        m = comm.pmax(x.detach() * (comm.rank + 1), "sp_ring")
        # the integer path: untracked, exact
        t = comm.all_gather(torch.arange(2) + 2 * comm.rank, "sp_ring", 0)
        return m, t

    res = ThreadMesh(1, 4).run(rank_fn, timeout=60)
    for m, t in res:
        assert torch.equal(m, torch.full((3,), 4.0))
        assert torch.equal(t, torch.arange(8))
    assert torch._C._is_multithreading_enabled()


def test_mismatched_collectives_raise():
    def rank_fn(comm):
        x = torch.ones(4)
        if comm.rank == 1:
            return comm.psum(x, "sp_ring")
        return comm.all_gather(x, "sp_ring", 0)

    with pytest.raises(RuntimeError, match="collective mismatch.*rank 1"):
        ThreadMesh(1, 4).run(rank_fn, timeout=30)

    def shapes(comm):
        return comm.psum(torch.ones(comm.rank % 2 + 1), "sp_ring")

    with pytest.raises(RuntimeError, match="collective mismatch"):
        ThreadMesh(1, 2).run(shapes, timeout=30)


def test_thread_mesh_collectives_under_fast_switching():
    """16 rank threads, a switch interval of 1 us: 200 rounds of psum and
    ppermute give exact sums and the right neighbours every time."""
    mesh = ThreadMesh(2, 2, data=2)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def rank_fn(comm):
            me = float(comm.rank)
            ring = [(i, (i + 1) % 2) for i in range(2)]
            for i in range(200):
                s = comm.psum(torch.tensor([me + i]), ("data", "sp_grp",
                                                      "sp_ring", "sp_team"))
                assert float(s) == 120.0 + 16 * i
                nb = comm.ppermute(torch.tensor([me]), "sp_ring", ring)
                assert threading.current_thread().name.endswith(
                    f"rank{comm.rank}")
            return float(nb)

        res = mesh.run(rank_fn, timeout=60)
    finally:
        sys.setswitchinterval(old)
    for rank, got in enumerate(res):
        co = mesh.coords(rank)
        # the sp_ring neighbour: same coordinates, the other ring index
        want = [i for i in range(mesh.size)
                if mesh.coords(i) == dict(co, sp_ring=1 - co["sp_ring"])]
        assert got == float(want[0])


# ---------------------------------------------------------------------------
# mesh layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [4, 8, 16])
def test_refine_grid_and_refinable_grids_match_jax(p):
    grid = np.arange(2 * p).reshape(2, p)
    for c in range(1, p + 1):
        for placement in meshes.PLACEMENTS:
            try:
                want = jax_meshes.refine_grid(grid, c, placement)
            except ValueError as e:
                with pytest.raises(ValueError, match="invalid for P"):
                    meshes.refine_grid(grid, c, placement)
                assert "invalid for P" in str(e)
                continue
            got = meshes.refine_grid(grid, c, placement)
            assert got.shape == want.shape and np.array_equal(got, want)
    with pytest.raises(ValueError, match="placement"):
        meshes.refine_grid(grid, 1, "nearest")
    with pytest.raises(ValueError, match="C must be"):
        meshes.refine_grid(grid, 0)
    assert (launch_mesh.refinable_grids(p)
            == jax_launch_mesh.refinable_grids(p))


def test_ring_inner_gives_the_team_inner_values():
    ctx = _ctx()
    model = from_jax_params(ctx["tree"], ctx["cfg"], "cpu")
    shape = ShapeConfig("test", SEQ, BATCH, "train")
    batch = _sharded(ctx["batch"], 8)
    out = {}
    for placement in meshes.PLACEMENTS:
        mesh = ThreadMesh(2, 2, placement=placement)
        out[placement] = _mesh_vg(model, mesh, RunConfig(c=2), shape,
                                  batch)[0]
    assert [mesh.coords(i)["sp_ring"] for i in range(4)] == [0, 1, 0, 1]
    (l0, g0), (l1, g1) = out["team_inner"], out["ring_inner"]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_make_plan_at_p_above_one():
    cfg = _ctx()["cfg"]
    shape = ShapeConfig("test", SEQ, BATCH, "train")
    plan = make_plan(cfg, shape, n_devices=8, data=2, c=2,
                     placement="ring_inner")
    mesh = plan.build_mesh()
    assert (mesh.c, mesh.r, mesh.data, mesh.placement) == (2, 1, 2,
                                                           "ring_inner")
    assert make_plan(cfg, shape, c=1).build_mesh() is None
    for kw, match in ((dict(n_devices=8, data=3), "not divisible"),
                      (dict(n_devices=8, data=4), "global_batch"),
                      (dict(n_devices=8, c=3), "invalid for P"),
                      (dict(n_devices=32, c=2), "zigzag layout"),
                      (dict(n_devices=64, c=2), "divisible by SP")):
        with pytest.raises(ValueError, match=match):
            make_plan(cfg, shape, **{"c": 1, **kw})
    with pytest.raises(ValueError, match="placement"):
        dataclasses.replace(plan, placement="nearest")


def test_launch_train_on_a_thread_mesh(tmp_path, capsys):
    from repro_torch.launch import train

    metrics = tmp_path / "m.jsonl"
    out = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--devices", "8", "--data", "2", "--c", "2",
                      "--steps", "3", "--metrics", str(metrics)])
    assert "P_sp=4 scheme=startrail C=2 R=1 data=2" in capsys.readouterr().out
    losses = [json.loads(x)["loss"] for x in metrics.read_text().splitlines()]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert out["step"] == 3
    with pytest.raises(ValueError, match=r"legal .*\[\(2, 4\), \(1, 8\)\]"):
        train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--devices", "8", "--c", "3"])
