"""Training loop (the port's counterpart of ``repro.train.trainer``): the
step loop, straggler detection and a jsonl metrics stream.

The run is described by a ``repro_torch.plan.ExecutionPlan``: the trainer
builds its runtime and train step from the plan. It runs on the CUDA card
unless the caller passes ``device='cpu'``.

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

Checkpoint save and restore (``dist/checkpoint.py``) are not ported yet:
``ckpt_dir`` raises (ROADMAP.md §A).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.dist.elastic import StragglerDetector
from repro_torch.engine.engine import resolve_device
from repro_torch.models.factory import Model
from repro_torch.optim import adamw
from repro_torch.plan.plan import ExecutionPlan
from repro_torch.train.step import to_device


@dataclasses.dataclass
class TrainerConfig:
    num_steps: int = 100
    ckpt_dir: Optional[str] = None     # not ported: set, it raises
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


def train(model: Model, plan: ExecutionPlan, adam_cfg: adamw.AdamWConfig,
          tcfg: TrainerConfig, data_source=None, device=None) -> Dict:
    """Run the loop on ``device`` (default: the CUDA card, raising if there
    is none; the model must live there); returns the last step's metrics.
    ``data_source`` (default ``SyntheticLM`` of the plan's shape) has
    ``get_batch(step) -> {tokens, labels}`` of numpy arrays."""
    if tcfg.ckpt_dir:
        raise NotImplementedError(
            "checkpointing (dist/checkpoint.py save / restore) is not "
            "ported to repro_torch yet (ROADMAP.md §A)")
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"model lives on {model.device}, trainer on "
                         f"{device}")
    shape = plan.shape_config()
    step_fn, sh = plan.build_train_step(model, adam_cfg)
    rt = sh["rt"]
    if data_source is None:
        data_source = SyntheticLM(model.cfg, shape, seed=tcfg.seed,
                                  seq_scheme=rt.st_cfg.seq_scheme,
                                  sp_size=plan.sp_size)
    opt = adamw.init_state(sh["params"], adam_cfg)

    prefetch = Prefetcher(data_source, start_step=0)
    detector = StragglerDetector()
    metrics_f = open(tcfg.metrics_path, "a") if tcfg.metrics_path else None
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
        for step_i in range(tcfg.num_steps):
            detector.step_start()
            t0 = time.perf_counter()
            _, batch_np = prefetch.next()
            batch = to_device(batch_np, device)
            t1 = time.perf_counter()
            opt, metrics = step_fn(opt, batch)
            done = _step_done_marker(device)
            # one-deep pipeline: wait on the *previous* step, while the
            # card is already busy with this one
            if prev_done is not None:
                prev_done.synchronize()
            t2 = time.perf_counter()
            prev_done = done
            straggling = detector.step_end()
            phases = {"data_s": t1 - t0, "step_s": t2 - t1}
            pending_metrics.append((step_i, metrics, straggling, phases))
            if ((step_i + 1) % tcfg.log_every == 0 or step_i == 0
                    or step_i + 1 == tcfg.num_steps):
                m = flush_metrics()
                if (step_i + 1) % tcfg.log_every == 0 or step_i == 0:
                    print(f"[trainer] step {step_i + 1} "
                          f"loss={m['loss']:.4f} "
                          f"gnorm={m['grad_norm']:.3f}", flush=True)
    finally:
        prefetch.stop()
        flush_metrics()
        if metrics_f:
            metrics_f.close()
    return last_metrics
