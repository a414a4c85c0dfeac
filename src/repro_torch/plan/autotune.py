"""Measured refinement of the analytical arrangement ranking (the port of
``repro.plan.autotune``; the paper's §3.4 profiling step).

The cost model ranks every legal (scheme, C, placement) arrangement; this
module times the top-k candidates (plus the analytical worst, as a sanity
anchor) with short train steps and persists the measured winner to
``results/repro_torch/PLAN_<arch>_<shape>.json`` (beside, never over, the
JAX package's ``results/PLAN_*.json``). The ranks of a plan run as the
threads of a ``ThreadMesh`` on one device, the counterpart of the JAX
search on its forced-host CPU mesh: on one card the ring's copies run
device to device on the ranks' comm streams, so the search ranks the
host's, the kernels' and the card's copies' time, not the wires'.

Every candidate trains from the same weights (the model is built once,
from its seed, and restored before each) with a fresh AdamW state; each
candidate's step, optimizer state and mesh are freed before the next.
Only an illegal plan (``ValueError`` from ``make_plan``) is skipped; a
failure during a measured step propagates.
"""

from __future__ import annotations

import gc
import json
import pathlib
import statistics
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.plan import cost
from repro_torch.plan.plan import ExecutionPlan, make_plan, plan_path

RESULTS = (pathlib.Path(__file__).resolve().parents[3] / "results"
           / "repro_torch")


def measure_plan(model, plan: ExecutionPlan, *, steps: int = 3,
                 warmup: int = 1, adam_cfg=None) -> float:
    """Median wall-clock seconds of the train step under ``plan`` (its
    ranks on ``plan.build_mesh()``) on the model's device, the device
    synchronised before and after each step. The step updates the model's
    parameters in place (callers restore them); the batch is
    ``SyntheticLM(seed=1)``'s first, in the plan's layout."""
    import torch

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.train import step as train_step

    device = model.device
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else lambda: None)
    adam_cfg = adam_cfg or adamw.AdamWConfig(warmup_steps=0,
                                             state_dtype=model.cfg.opt_dtype)
    step_fn, sh = plan.build_train_step(model, adam_cfg)
    opt = adamw.init_state(sh["params"], adam_cfg)
    batch = train_step.to_device(
        SyntheticLM(model.cfg, plan.shape_config(), seed=1,
                    seq_scheme=plan.seq_scheme,
                    sp_size=plan.sp_size).get_batch(0), device)
    for _ in range(max(warmup, 1)):
        opt, _ = step_fn(opt, batch)
    times = []
    for _ in range(max(steps, 1)):
        sync()
        t0 = time.perf_counter()
        opt, _ = step_fn(opt, batch)
        sync()
        times.append(time.perf_counter() - t0)
    return float(statistics.median(times))


def autotune(cfg: ModelConfig, shape: ShapeConfig, *, arch: str,
             n_devices: int, data: int = 1, mesh_kind: str = "local",
             top_k: int = 3, steps: int = 3,
             microbatches: Optional[int] = 1, out_dir=None, cluster=None,
             arrangements: Optional[Sequence[cost.Arrangement]] = None,
             overlap_frac: float = 1.0,
             comm_chunk_grid: Sequence[int] = (1,),
             warmup: int = 1, device=None, seed: int = 0,
             ) -> Dict[str, object]:
    """Measure the analytical top-k (plus the analytical worst) and persist
    the winner.

    Returns {"plan": ExecutionPlan, "measured": [...], "analytical": [...],
    "path": written json path}. The measured list is sorted fastest-first.
    ``overlap_frac`` is the ranking's overlap model (pass the measured
    fraction from ``obs.commlog.overlap_report``); ``arrangements`` limits
    the ranking to those. Each candidate is measured once per entry of
    ``comm_chunk_grid`` that is legal for it: Ulysses has no ring to chunk,
    and a chunk count must divide the team sequence C*N/P. A plan of
    ``mesh_kind='production'`` raises (``ExecutionPlan.check_runnable``).
    The model is built on ``device`` (default: the CUDA card, raising
    without one) from ``seed``.
    """
    import torch

    from repro_torch.engine.engine import resolve_device
    from repro_torch.models.factory import build_model

    device = resolve_device(device)
    sp = n_devices // data
    ranking = cost.rank_arrangements(
        cfg, shape, sp, batch=max(shape.global_batch // data, 1),
        cluster=cluster, arrangements=arrangements,
        overlap_frac=overlap_frac)
    cands = list(ranking[:top_k])
    if ranking[-1] not in cands:
        cands.append(ranking[-1])   # anchor: the analytical worst

    runs = []                       # (ranking entry, chunks, plan)
    for entry in cands:
        arr: cost.Arrangement = entry["arrangement"]
        for n_chunks in dict.fromkeys(comm_chunk_grid):
            s_team = arr.c * shape.seq_len // sp
            if arr.scheme == "ulysses" and n_chunks > 1:
                continue            # no ring to chunk
            if n_chunks > 1 and s_team % n_chunks:
                continue
            try:
                plan = make_plan(
                    cfg, shape, arch=arch, n_devices=n_devices, data=data,
                    scheme=arr.scheme, c=arr.c,
                    placement=arr.placement if arr.c > 1 else None,
                    microbatches=microbatches, mesh_kind=mesh_kind,
                    comm_chunks=n_chunks, overlap_frac=overlap_frac,
                    cluster=cluster)
            except ValueError:
                continue
            plan.check_runnable()   # before the model takes the card
            runs.append((entry, n_chunks, plan))

    model = build_model(cfg, device=device, seed=seed)
    init = [t.detach().clone() for t in model.parameters()]
    measured: List[Dict[str, object]] = []
    for entry, n_chunks, plan in runs:
        with torch.no_grad():
            for t, t0 in zip(model.parameters(), init):
                t.copy_(t0)
        t = measure_plan(model, plan, steps=steps, warmup=warmup)
        measured.append({"arrangement": entry["arrangement"], "plan": plan,
                         "comm_chunks": n_chunks, "measured_s": t,
                         "analytical_s": entry["total_s"]})
        # the step, its optimizer state and mesh went out of scope: free
        # them before the next candidate builds its own
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    del model, init
    measured.sort(key=lambda e: e["measured_s"])
    winner: ExecutionPlan = measured[0]["plan"]

    out_dir = pathlib.Path(out_dir) if out_dir is not None else RESULTS
    path = plan_path(out_dir, arch, shape.name)
    record = {
        "plan": winner.to_dict(),
        "measured": [{"arrangement": e["arrangement"].key,
                      "comm_chunks": e["comm_chunks"],
                      "measured_s": e["measured_s"],
                      "analytical_s": e["analytical_s"]} for e in measured],
        "overlap_frac": overlap_frac,
        "analytical": [{"arrangement": e["arrangement"].key,
                        "total_s": e["total_s"],
                        "volumes": e["volumes"]} for e in ranking],
        "n_devices": n_devices, "data": data, "steps_timed": steps,
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(record, indent=2))
    return {"plan": winner, "measured": measured, "analytical": ranking,
            "path": path}
