"""Training loop (the port's counterpart of ``repro.train.trainer``): the
step loop, checkpoint and restart, straggler detection and a jsonl
metrics stream.

The run is described by a ``repro_torch.plan.ExecutionPlan``: the trainer
builds its train step from the plan. It runs on the CUDA card unless the
caller passes ``device='cpu'``. A plan with ``n_devices > 1`` runs its
ranks as the threads of a ``ThreadMesh`` (``plan.build_mesh``) on that
device: each step hands the global batch to every rank and updates each
unique parameter shard once (``train.step``). The ``Model`` holds every
parameter whole and the AdamW moments are whole tensors whose blocks are
the unique shards' moments. Given a ``ProcessComm`` the loop runs one rank
process on its ``rank_model``, whose parameters and moments are its shards
(``dist.procs`` runs one loop per rank). A checkpoint holds whole leaves
either way (a rank process's are assembled on rank 0,
``checkpoint.gather_leaves``), so it does not depend on the plan: one
written under any mesh, sharding rules or communicator restores under any
other.

Metrics stay on the device between log boundaries: converting a device
scalar to ``float`` blocks the host on the step, so the loop buffers the
metric tensors and reads them only on ``log_every`` boundaries, on the
first step and at exit; the jsonl stream still carries every step. The
loop waits on the *previous* step before dispatching past it (a one-deep
pipeline: an event recorded after each step's work, synchronised one step
later), so the card keeps computing while the host prepares the next
batch, run-ahead stays bounded, and the straggler detector measures real
step durations. ``step_s`` is that step's dispatch plus the wait on the
step before it.

With ``ckpt_dir`` the loop restores the parameters (in place) and the
AdamW state from the newest step both trees completed
(``checkpoint.latest_common_step``), resumes the data stream at that step,
and every ``ckpt_every`` steps saves both trees asynchronously (the
previous pair joined first), in the JAX package's format and layout:
parameters as the JAX tree (``factory.jax_tree``: stacked layers, each in
its dtype) in ``ckpt_dir``, the optimizer as ``{"mu", "nu", "step"}`` in
``ckpt_dir/opt``. Either package's checkpoint restores in the other.

Observability, off by default as in the JAX trainer: a ``tracer``
(``obs.Tracer``) spans each step's phases (``train/data``, ``train/step``,
``train/ckpt``); a ``registry`` (``obs.Registry``) gets the per-step
analytical comm-volume counters of ``obs.commlog.CommLog`` and the bytes
the step's communicator counted in its ledger (rank 0's: every rank of a
scheme moves the same), which is reset before each step: the whole
step's, the rules' parameter gathers (again in the recompute), their
reduce-scatters and the gradient reduction included.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.dist import checkpoint
from repro_torch.dist.comm import ProcessComm
from repro_torch.dist.elastic import StragglerDetector
from repro_torch.engine.engine import resolve_device
from repro_torch.models.factory import (Model, from_jax_tree, jax_tree,
                                        whole_shapes)
from repro_torch.obs import NULL_TRACER, Registry, Tracer
from repro_torch.obs.commlog import CommLog
from repro_torch.optim import adamw
from repro_torch.plan.plan import ExecutionPlan
from repro_torch.train.step import to_device


@dataclasses.dataclass
class TrainerConfig:
    num_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    metrics_path: Optional[str] = None
    seed: int = 0


def _step_done_marker(device: torch.device):
    """An event recorded after the work queued so far (None on the CPU,
    where every op has finished when it returns)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def opt_tree(opt: Dict, names: Sequence[str], cfg, device=None) -> Dict:
    """The AdamW state in the JAX ``init_state`` layout: ``mu`` and ``nu``
    as parameter trees, ``step`` an int32 scalar."""
    return {"mu": jax_tree(dict(zip(names, opt["mu"])), cfg, device),
            "nu": jax_tree(dict(zip(names, opt["nu"])), cfg, device),
            "step": torch.tensor(opt["step"], dtype=torch.int32)}


def restore_latest(ckpt_dir, model: Model, names: Sequence[str],
                   opt: Dict, comm=None) -> Optional[int]:
    """Load the newest step completed in both ``ckpt_dir`` (parameters)
    and ``ckpt_dir/opt`` into ``model`` and ``opt`` in place; returns the
    step, or None when there is none. On a rank process (``comm`` a
    ``ProcessComm``, ``model`` its ``rank_model``) the ranks agree on the
    step and each keeps its blocks of the whole leaves."""
    opt_dir = pathlib.Path(ckpt_dir) / "opt"
    last = (checkpoint.agreed_step(comm, ckpt_dir, opt_dir)
            if isinstance(comm, ProcessComm)
            else checkpoint.latest_common_step(ckpt_dir, opt_dir))
    if last is None:
        return None
    cfg = model.cfg
    shapes = whole_shapes(model)
    held = getattr(model, "held", None)
    blocks = (held["blocks"] if held is not None
              else [(slice(None),) * len(shapes[n]) for n in names])
    params = dict(model.named_parameters())
    like = {n: torch.empty(shapes[n], dtype=params[n].dtype, device="meta")
            for n in names}
    rows = {"params": from_jax_tree(checkpoint.restore(
        ckpt_dir, last, jax_tree(like, cfg, "meta")), names, cfg)}
    tree = checkpoint.restore(opt_dir, last, opt_tree(
        {"mu": [like[n].to(m.dtype) for n, m in zip(names, opt["mu"])],
         "nu": [like[n].to(m.dtype) for n, m in zip(names, opt["nu"])],
         "step": 0}, names, cfg, "meta"))
    for key in ("mu", "nu"):
        rows[key] = from_jax_tree(tree[key], names, cfg)
    with torch.no_grad():
        for i, name in enumerate(names):
            for key, dst in (("params", params[name]), ("mu", opt["mu"][i]),
                             ("nu", opt["nu"][i])):
                src = rows[key][name][blocks[i]]
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"{name}: checkpoint block "
                                     f"{tuple(src.shape)} vs "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src)
    opt["step"] = int(tree["step"])
    return last


def _save(ckpt_dir, step: int, sh: Dict, opt: Dict, cfg) -> List:
    """Start writing both trees of ``step`` (module doc); returns the
    writer threads (none on a rank process other than rank 0, which
    writes the whole leaves the ranks' shards assemble into)."""
    names, comm = sh["names"], sh["comm"]
    trees = {"params": sh["params"], "mu": opt["mu"], "nu": opt["nu"]}
    if isinstance(comm, ProcessComm):
        held = sh["held"]
        layouts = sh["layouts"]
        trees = {k: checkpoint.gather_leaves(comm, v, names, layouts,
                                             held["shapes"])
                 for k, v in trees.items()}
        if comm.rank != 0:
            return []
    opt_host = {"mu": trees["mu"], "nu": trees["nu"], "step": opt["step"]}
    return [
        checkpoint.save(ckpt_dir, step, jax_tree(
            dict(zip(names, trees["params"])), cfg, "cpu"), blocking=False),
        checkpoint.save(pathlib.Path(ckpt_dir) / "opt", step, opt_tree(
            opt_host, names, cfg, "cpu"), blocking=False),
    ]


def train(model: Model, plan: ExecutionPlan, adam_cfg: adamw.AdamWConfig,
          tcfg: TrainerConfig, data_source=None, device=None,
          tracer: Optional[Tracer] = None,
          registry: Optional[Registry] = None, comm=None) -> Dict:
    """Run the loop on ``device`` (default: the CUDA card, raising if there
    is none; the model must live there); returns the last step's metrics.
    ``data_source`` (default ``SyntheticLM`` of the plan's shape) has
    ``get_batch(step) -> {tokens, labels}`` of numpy arrays. Restores from
    ``tcfg.ckpt_dir`` if it holds a checkpoint (fault-tolerant restart).
    ``tracer`` spans the loop's phases; ``registry`` gets the comm-volume
    counters (module doc). Both are off by default. ``comm`` (default: the
    plan's ``ThreadMesh``, or one card) may be this process's
    ``ProcessComm``, with ``model`` its ``rank_model``: the loop then runs
    this rank, and only rank 0 prints, writes the metrics stream and the
    checkpoints, and fills ``registry``."""
    tracer = tracer if tracer is not None else NULL_TRACER
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"model lives on {model.device}, trainer on "
                         f"{device}")
    shape = plan.shape_config()
    step_fn, sh = plan.build_train_step(model, adam_cfg, comm)
    lead = not isinstance(sh["comm"], ProcessComm) or sh["comm"].rank == 0
    if not lead:
        registry, tcfg = None, dataclasses.replace(tcfg, metrics_path=None)
    if data_source is None:
        data_source = SyntheticLM(model.cfg, shape, seed=tcfg.seed,
                                  seq_scheme=plan.seq_scheme,
                                  sp_size=plan.sp_size)
    opt = adamw.init_state(sh["params"], adam_cfg)
    comm = sh["comm"]
    commlog = CommLog(registry, model.cfg, plan) if registry is not None \
        else None
    start = 0
    if tcfg.ckpt_dir:
        last = restore_latest(tcfg.ckpt_dir, model, sh["names"], opt, comm)
        if last is not None:
            start = last
            if lead:
                print(f"[trainer] restored step {last}", flush=True)

    prefetch = Prefetcher(data_source, start_step=start)
    detector = StragglerDetector()
    metrics_f = open(tcfg.metrics_path, "a") if tcfg.metrics_path else None
    pending_ckpt = None
    last_metrics: Dict = {}
    # (step_i, on-device metrics, straggler flag, host phase timings)
    # buffered between flushes
    pending_metrics: List[Tuple[int, Dict, bool, Dict[str, float]]] = []

    def flush_metrics() -> Dict:
        nonlocal last_metrics
        for si, dev_m, straggling, phases in pending_metrics:
            m = {k: float(v) for k, v in dev_m.items()}
            if straggling:
                m["straggler_flag"] = 1.0
            last_metrics = {"step": si + 1, **m, **phases}
            if metrics_f:
                metrics_f.write(json.dumps(last_metrics) + "\n")
        if metrics_f and pending_metrics:
            metrics_f.flush()
        pending_metrics.clear()
        return last_metrics

    prev_done = None
    try:
        for step_i in range(start, tcfg.num_steps):
            detector.step_start()
            t0 = time.perf_counter()
            with tracer.span("train/data", cat="train", step=step_i + 1):
                _, batch_np = prefetch.next()
                batch = to_device(batch_np, device)
            t1 = time.perf_counter()
            if commlog is not None:
                comm.reset_ledgers()
            with tracer.span("train/step", cat="train", step=step_i + 1):
                opt, metrics = step_fn(opt, batch)
                done = _step_done_marker(device)
                # one-deep pipeline: wait on the *previous* step, while the
                # card is already busy with this one
                if prev_done is not None:
                    prev_done.synchronize()
            t2 = time.perf_counter()
            prev_done = done
            straggling = detector.step_end()
            if commlog is not None:
                commlog.record_step()
                commlog.record_ledger(comm.ledgers[0])
            phases = {"data_s": t1 - t0, "step_s": t2 - t1, "ckpt_s": 0.0}
            pending_metrics.append((step_i, metrics, straggling, phases))
            ckpt_boundary = (tcfg.ckpt_dir
                             and (step_i + 1) % tcfg.ckpt_every == 0)
            if ckpt_boundary:
                t3 = time.perf_counter()
                with tracer.span("train/ckpt", cat="train",
                                 step=step_i + 1):
                    for t in pending_ckpt or ():
                        t.join()
                    # both writes async: save() snapshots to the host in
                    # this thread before it returns, and a restart takes
                    # the newest step common to both trees, so a crash
                    # mid-write costs the torn step, never consistency
                    pending_ckpt = _save(tcfg.ckpt_dir, step_i + 1, sh, opt,
                                         model.cfg)
                phases["ckpt_s"] = time.perf_counter() - t3
            if ((step_i + 1) % tcfg.log_every == 0 or step_i == start
                    or ckpt_boundary or step_i + 1 == tcfg.num_steps):
                m = flush_metrics()
                if lead and ((step_i + 1) % tcfg.log_every == 0
                             or step_i == start):
                    print(f"[trainer] step {step_i + 1} "
                          f"loss={m['loss']:.4f} "
                          f"gnorm={m['grad_norm']:.3f}", flush=True)
    finally:
        prefetch.stop()
        flush_metrics()
        for t in pending_ckpt or ():
            t.join()
        if metrics_f:
            metrics_f.close()
    return last_metrics
