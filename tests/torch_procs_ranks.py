"""Rank functions for ``tests/test_torch_procs.py``.

The ranks of a ``dist.procs.ProcessMesh`` import this module (``spawn``
pickles a function by its module and name), so it imports ``torch`` and
``repro_torch`` only: no JAX, nothing of ``repro``. Each function takes a
rank's communicator first, so a ``ThreadMesh`` runs the same function on
its threads (``mesh.run(lambda comm: fn(comm, ...))``) for the reference.
"""

import hashlib
import os
import pathlib
import sys
import time

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.dist.sharding import MESH_AXES
from repro_torch.models.factory import (from_jax_params, rank_model,
                                        shard_blocks)
from repro_torch.optim import adamw
from repro_torch.train import step as train_step
from repro_torch.train import trainer

ARCH = "h2o-danube-1.8b"
ADAM = dict(learning_rate=1e-3, warmup_steps=0)
# (op, its axes, its arguments): group orders that differ from the
# process groups' rank order, a permute that leaves one rank without a
# sender, and the split-phase permute
COLLECTIVES = (
    ("all_gather", ("sp_team", "sp_grp"), dict(dim=1)),
    ("psum", ("sp_grp", "sp_team"), {}),
    ("psum_scatter", "sp_team", dict(dim=0)),
    ("all_to_all", ("sp_team", "sp_grp"), dict(split_axis=1, concat_axis=2)),
    ("ppermute", ("sp_grp", "sp_team"),
     dict(perm=[(0, 1), (1, 2), (2, 3), (3, 0)])),
    ("ppermute_open", ("sp_team", "sp_grp"),
     dict(perm=[(0, 2), (2, 1), (1, 3)])),
    ("ppermute_start", ("sp_grp", "sp_team"),
     dict(perm=[(0, 3), (3, 2), (2, 1), (1, 0)])),
    ("pmax", ("sp_grp", "sp_team"), {}),
    ("pmin", "sp_grp", {}),
)
DIFFERENTIABLE = ("all_gather", "psum", "psum_scatter", "all_to_all",
                  "ppermute", "ppermute_open")


def collectives(comm):
    """Each collective's output and, where it carries one, the gradient of
    <output, cotangent> with respect to its input, on rank-seeded inputs;
    then the rank's ledger."""
    comm.ledger.reset()
    gen = torch.Generator().manual_seed(100 + comm.rank)
    out = {}
    for op, axes, kw in COLLECTIVES:
        x = torch.randn(4, 8, 6, generator=gen)
        if op in DIFFERENTIABLE:
            x.requires_grad_()
            name = "ppermute" if op.startswith("ppermute") else op
            y = getattr(comm, name)(x, axes, **kw)
            ct = torch.randn(y.shape, generator=gen)
            (grad,) = torch.autograd.grad((y * ct).sum(), x)
            out[op] = (y.detach(), grad)
        elif op == "ppermute_start":
            out[op] = (comm.ppermute_start(x, axes, **kw).wait(), None)
        else:
            out[op] = (getattr(comm, op)(x, axes), None)
    return out, comm.ledger.snapshot()


def mismatch(comm):
    """Ranks of one group that run different collectives, then different
    shapes: each rank's error message (None where it did not raise), and
    a psum after them, which must still meet."""
    errors = []
    x = torch.ones(4)
    for wrong in ("op", "shape"):
        try:
            if wrong == "op" and comm.axis_index("sp_team") == 1:
                comm.all_gather(x, "sp_team", 0)
            elif wrong == "shape" and comm.axis_index("sp_team") == 1:
                comm.psum(torch.ones(5), "sp_team")
            else:
                comm.psum(x, "sp_team")
            errors.append(None)
        except RuntimeError as e:
            errors.append(str(e))
    return errors, comm.psum(x, MESH_AXES)


def imports(comm):
    """The JAX and ``repro`` modules this rank process has imported."""
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib"))
                  or m == "repro" or m.startswith("repro."))


def _model(comm, tree, rules="default"):
    cfg = registry.get_smoke(ARCH)
    return rank_model(from_jax_params(tree, cfg, "cpu"), comm, rules)


def value_and_grad(comm, tree, batch, c, seq, rows):
    """(loss, every held shard's reduced gradient, their blocks, the
    ledger) of one ``value_and_grad`` on the rank's ``rank_model``."""
    model = _model(comm, tree)
    vg_fn, rt = train_step.build_value_and_grad_fn(
        model, RunConfig(c=c, seq_scheme="zigzag", remat="none"),
        ShapeConfig("test", seq, rows, "train"), comm)
    comm.ledger.reset()
    loss, grads = vg_fn(train_step.shard_batch(batch, rt))
    return (loss, grads, shard_blocks(model, comm, rt.rules),
            comm.ledger.snapshot())


def adam_steps(comm, tree, batch, c, seq, rows, compression, steps):
    """``steps`` train steps on one batch: (each step's metrics, the held
    shards after them, their moments, the ledger of the first step)."""
    model = _model(comm, tree)
    adam = adamw.AdamWConfig(**ADAM)
    step_fn, sh = train_step.build_train_step(
        model, RunConfig(c=c, seq_scheme="zigzag", remat="none",
                         grad_compression=compression),
        ShapeConfig("test", seq, rows, "train"), adam, comm)
    opt = adamw.init_state(sh["params"], adam)
    metrics, ledger = [], None
    for i in range(steps):
        comm.ledger.reset()
        opt, m = step_fn(opt, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        ledger = ledger or comm.ledger.snapshot()
    return (metrics, [p.clone() for p in sh["params"]], opt["mu"],
            opt["nu"], ledger, sh["held"]["blocks"])


def save(comm, tree, plan, ckpt_dir, steps):
    """``steps`` trainer steps on the plan, checkpointing the last into
    ``ckpt_dir``: (the held shards after them, their blocks)."""
    model = _model(comm, tree, plan.sharding_rules)
    tcfg = trainer.TrainerConfig(num_steps=steps, ckpt_every=steps,
                                 ckpt_dir=ckpt_dir, log_every=steps)
    trainer.train(model, plan, adamw.AdamWConfig(**ADAM), tcfg,
                  device="cpu", comm=comm)
    return ([p.detach().clone() for p in model.parameters()],
            model.held["blocks"])


def restore(comm, tree, plan, ckpt_dir):
    """A fresh ``rank_model`` and AdamW state restored from ``ckpt_dir``:
    (step, its shards, their moments, their blocks)."""
    model = _model(comm, tree, plan.sharding_rules)
    params = [p for _, p in model.named_parameters()]
    opt = adamw.init_state(params, adamw.AdamWConfig(**ADAM))
    names = [n for n, _ in model.named_parameters()]
    step = trainer.restore_latest(ckpt_dir, model, names, opt, comm)
    return step, params, opt["mu"], opt["nu"], model.held["blocks"]


def fail(comm):
    """Rank 1 raises; the others wait in a collective that never meets."""
    if comm.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return comm.psum(torch.ones(3), MESH_AXES)


def slow_build(path: pathlib.Path) -> str:
    """A stand-in for nvcc: writes 64 KiB in slow pieces and notes the
    build in ``<dir>/builds``."""
    with open(path.parent / "builds", "a") as f:
        f.write(f"{os.getpid()}\n")
    with open(path, "wb") as f:
        for i in range(16):
            f.write(bytes([i]) * 4096)
            f.flush()
            time.sleep(0.01)
    return "log of the stand-in build"


def load_built(out: str, log: str):
    """``ensure_built`` with the stand-in: (whether this process built,
    the library's sha256, the log)."""
    from repro_torch.kernels import _build

    built = _build.ensure_built(pathlib.Path(out), pathlib.Path(log),
                                build=slow_build)
    return (built, hashlib.sha256(pathlib.Path(out).read_bytes()).hexdigest(),
            pathlib.Path(log).read_text())


def jobs(comm, *calls):
    """Each (function name, args) of this module in turn on this rank,
    the results in order: one spawn of the mesh serves many checks."""
    return [globals()[name](comm, *args) for name, args in calls]
