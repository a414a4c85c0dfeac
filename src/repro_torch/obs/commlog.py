"""Per-collective communication accounting: measured against analytical
bytes for a plan's arrangement (the port of ``repro.obs.commlog``).

Three layers:

  * ``analytical_wire_volumes(cfg, plan)``: the ``plan.cost.comm_volumes``
    closed forms (paper eqs. 2-4) regrouped by collective kind: team
    all-gather, placement + sub-ring ppermute (collective-permute),
    lse-combine reduce-scatter, Ulysses all-to-all.
  * ``measure_attention_island(cfg, plan)``: one forward of one attention
    layer on a ``ThreadMesh`` of the plan's (C, R), read from the
    communicator's ledger (``dist.comm.CommLedger``), which converts each
    collective's result bytes to per-device wire bytes with the factors of
    the JAX module's table: all-gather (c-1)/c, reduce-scatter (c-1),
    collective-permute 1, all-to-all (p-1)/p. It takes the place of the
    JAX module's parse of the compiled HLO, which has no counterpart here.
  * ``comm_report(cfg, plan)``: the per-kind table of measured bytes,
    the bytes ``island_wire_volumes`` says this implementation's forward
    moves (``analytical_bytes``, the ratio's denominator) and the eqs. 2-4
    closed form (``eqs_bytes``), with one ``within_tolerance`` verdict.
    The ledger counts bytes exactly, so every live kind reads ratio 1.0.

The lse-combine ``pmax``/``psum`` all-reduces (numerics glue, not a paper
term) are unmodelled: reported under ``unmodelled_allreduce_bytes``, left
out of the verdict.

The wire dtype is the element size of the run's inputs (bf16: 2 bytes),
for both sides; the combine's reduce-scatter is f32 on both.

``overlap_report(cfg, plan)`` is the port of the JAX report of the same
name: how much of the ring's transfers the block kernels can hide under
the plan's issue order (``pipeline_scan``) and ring chunks. JAX reads it
from the compiled HLO's schedule (``roofline.hlo.collective_overlap``:
dot instructions inside a collective-permute's issue -> first-use window).
The port has no compiler between the loop and the card: one fused block
kernel (B2 forward, B3 backward) is one launch per ring step, and the
order the loop issues them in is the schedule. So the port counts from
each ``ThreadMesh`` rank's issue log (``dist.comm``): a "dot" is one
block-kernel call, overlapped when it falls inside a permute's
``ppermute_start`` -> ``wait`` window. The pipelined ring gives (R-1)/R
of the forward's block calls a window, the unpipelined one none; JAX's
count (XLA hoists the permutes in either order, two dots a block) is not
the port's. On a CUDA card the report also times the run
(``torch.profiler``): ``timed_overlap_fraction`` is the share of the
permutes' copy time, on the ranks' comm streams, during which a kernel ran
on another stream.

``CommLog`` is the trainer's face: it prices one train step's attention
communication once at construction (analytical wire bytes x attention
layers x 3, the JAX module's forward + backward convention) and ticks the
``comm_bytes_total{collective=...}`` counters per step; ``record_ledger``
adds the bytes a step's communicator measured,
``comm_ledger_bytes_total{collective=..., pass=...}``. Host arithmetic
only, no device sync.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.dist.comm import WIRE_KINDS, CommLedger
from repro_torch.dist.sharding import MESH_AXES
from repro_torch.plan import cost

#: collective kind <- cost.comm_volumes components.
KIND_FROM_COMPONENTS = {
    "all-gather": ("team_allgather",),
    "collective-permute": ("placement_p2p", "ring_p2p"),
    "reduce-scatter": ("combine_rs",),
    "all-to-all": ("all_to_all",),
}

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def _arrangement(plan) -> cost.Arrangement:
    return cost.Arrangement(plan.scheme, plan.c, plan.r,
                            placement=plan.placement)


def _volumes(cfg: ModelConfig, plan, batch: int, seq_len: Optional[int],
             dtype_bytes: int) -> Dict[str, float]:
    shape = ShapeConfig(plan.shape, seq_len=seq_len or plan.seq_len,
                        global_batch=batch, kind="train")
    return cost.comm_volumes(cfg, shape, plan.sp_size, _arrangement(plan),
                             batch=batch, dtype_bytes=dtype_bytes)


def analytical_wire_volumes(cfg: ModelConfig, plan, *, batch: int = 1,
                            seq_len: Optional[int] = None,
                            dtype_bytes: int = 2) -> Dict[str, float]:
    """Per-device wire bytes per attention layer, keyed by kind."""
    vols = _volumes(cfg, plan, batch, seq_len, dtype_bytes)
    return {kind: sum(vols[c] for c in comps)
            for kind, comps in KIND_FROM_COMPONENTS.items()}


def island_wire_volumes(cfg: ModelConfig, plan, *, batch: int = 1,
                        seq_len: Optional[int] = None,
                        dtype_bytes: int = 2) -> Dict[str, float]:
    """What one forward of this implementation's attention island moves.

    ``analytical_wire_volumes`` except collective-permute, which is the
    placement plus R-1 ring hops of one team's K/V chunk: the port's
    forward drops the JAX ring's last fetch (dead: it only rotates K/V back
    into placement order), and its placement is the identity at C = 1 and
    moves nothing. At C > 1 that is R chunks, the JAX island's count; at
    C = 1 it is R-1, one chunk fewer than the JAX island's R.
    """
    vols = _volumes(cfg, plan, batch, seq_len, dtype_bytes)
    out = {kind: sum(vols[c] for c in comps)
           for kind, comps in KIND_FROM_COMPONENTS.items()}
    hop = vols["ring_p2p"] / plan.r
    out["collective-permute"] = vols["placement_p2p"] + (plan.r - 1) * hop
    return out


def measure_attention_island(cfg: ModelConfig, plan, *, batch: int = 1,
                             seq_len: Optional[int] = None,
                             dtype: torch.dtype = torch.bfloat16,
                             device=None, comm=None) -> Dict[str, object]:
    """One forward of one attention layer (the plan's scheme and ring
    chunks; random seeded q, k, v of ``dtype``) on a
    ``ThreadMesh(plan.c, plan.r)`` on ``device`` (default: the CUDA card),
    or, with ``comm`` a ``ProcessComm`` of the plan's mesh, on every rank
    process (each calls this; every data replica runs the island), read
    from every rank's ledger: per-device wire bytes by kind (the largest
    over the ranks) and the calls of rank 0. A rank process's ledger is
    reset first, and the ranks' ledgers cross by an all-gather over the
    mesh, off the ledger."""
    from repro_torch.core import startrail as st
    from repro_torch.core import ulysses as ul
    from repro_torch.dist.comm import ThreadMesh
    from repro_torch.engine.engine import resolve_device

    device = resolve_device(device)
    n = seq_len or plan.seq_len
    st_cfg = st.StarTrailConfig(
        seq_len=n, seq_scheme=plan.seq_scheme, causal=True,
        block_impl=plan.block_impl, comm_chunks=plan.comm_chunks)
    attention = (ul.ulysses_attention if plan.scheme == "ulysses"
                 else st.startrail_attention)
    s_local = n // plan.sp_size
    heads = (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads)

    def rank_fn(comm):
        g = torch.Generator(device=device).manual_seed(comm.rank)
        q, k, v = (torch.randn((batch, s_local, h, cfg.head_dim_),
                               generator=g, device=device).to(dtype)
                   for h in heads)
        with torch.no_grad():
            attention(q, k, v, st_cfg, comm)
        return comm.ledger

    if comm is None:
        ledgers = ThreadMesh(plan.c, plan.r, placement=plan.placement).run(
            rank_fn)
        fwd = [ledger.bytes["forward"] for ledger in ledgers]
        calls0 = ledgers[0].calls["forward"]
    else:
        comm.reset_ledgers()
        fwd, calls0 = _gathered_ledgers(rank_fn(comm), comm, device)
    return {
        "wire_bytes_by_kind": {kind: max(f[kind] for f in fwd)
                               for kind in KIND_FROM_COMPONENTS},
        "count_by_kind": {k: v for k, v in calls0.items() if v},
        "unmodelled_allreduce_bytes": max(f["all-reduce"] for f in fwd),
        "ranks_agree": all(f == fwd[0] for f in fwd),
    }


def _gathered_ledgers(ledger, comm, device):
    """Every rank's forward bytes by kind, in rank order, and rank 0's
    forward calls, from this rank's ``ledger`` (an all-gather over the
    mesh, off the ledger)."""
    mine = torch.tensor([[ledger.bytes["forward"][k] for k in WIRE_KINDS]
                         + [ledger.calls["forward"][k] for k in WIRE_KINDS]],
                        dtype=torch.int64, device=device)
    with ledger.uncounted():
        rows = comm.all_gather(mine, MESH_AXES, 0).tolist()
    n = len(WIRE_KINDS)
    return ([dict(zip(WIRE_KINDS, row[:n])) for row in rows],
            dict(zip(WIRE_KINDS, rows[0][n:])))


def comm_report(cfg: ModelConfig, plan, *, batch: int = 1,
                seq_len: Optional[int] = None, tolerance: float = 0.05,
                dtype: torch.dtype = torch.bfloat16, device=None,
                comm=None) -> Dict[str, object]:
    """Measured-vs-analytical per-collective report for one attention
    layer's forward on the plan's arrangement (on a ``ThreadMesh``, or on
    every rank process of ``comm``'s mesh: ``measure_attention_island``).
    ``within_tolerance`` covers every kind with non-zero analytical
    volume (and a measured kind with none). Each kind's ``eqs_bytes`` is
    ``analytical_wire_volumes``, the paper's closed form, beside the
    island's ``analytical_bytes``."""
    n = seq_len or plan.seq_len
    dtype_bytes = torch.empty((), dtype=dtype).element_size()
    analytical = island_wire_volumes(cfg, plan, batch=batch, seq_len=n,
                                     dtype_bytes=dtype_bytes)
    eqs = analytical_wire_volumes(cfg, plan, batch=batch, seq_len=n,
                                  dtype_bytes=dtype_bytes)
    measured = measure_attention_island(cfg, plan, batch=batch, seq_len=n,
                                        dtype=dtype, device=device,
                                        comm=comm)
    kinds = {}
    ok = True
    for kind, a in analytical.items():
        m = measured["wire_bytes_by_kind"][kind]
        ratio = (m / a) if a else (None if m == 0 else float("inf"))
        within = ratio is None or abs(ratio - 1.0) <= tolerance
        ok = ok and within
        kinds[kind] = {"measured_bytes": m, "analytical_bytes": a,
                       "eqs_bytes": eqs[kind], "ratio": ratio,
                       "within_tolerance": within}
    return {
        "arrangement": {"scheme": plan.scheme, "c": plan.c, "r": plan.r,
                        "sp": plan.sp_size, "placement": plan.placement,
                        "seq_scheme": plan.seq_scheme,
                        "comm_chunks": plan.comm_chunks},
        "shape": {"batch": batch, "seq_len": n,
                  "num_heads": cfg.num_heads,
                  "num_kv_heads": cfg.num_kv_heads,
                  "head_dim": cfg.head_dim_,
                  "dtype_bytes": dtype_bytes},
        "per_collective": kinds,
        "unmodelled_allreduce_bytes":
            measured["unmodelled_allreduce_bytes"],
        "collective_counts": measured["count_by_kind"],
        "ranks_agree": measured["ranks_agree"],
        "tolerance": tolerance,
        "within_tolerance": ok,
    }


#: The ring's scopes (``core.startrail``, the JAX ``jax.named_scope``
#: names): ``torch.profiler`` ranges, noted in a rank's issue log.
RING_SCOPES = ("ring_permute_issue", "ring_block_compute")


def ring_scope_counts(issue_log, phase: str = "forward") -> Dict[str, int]:
    """How many times each ring scope was entered in one pass of a rank's
    issue log (the port's count of the JAX module's HLO instructions
    carrying each scope)."""
    counts = dict.fromkeys(RING_SCOPES, 0)
    for event in issue_log:
        if event[0] == "scope" and event[-1] == phase:
            counts[event[1]] += 1
    return counts


def issue_overlap(issue_log, phase: str = "forward") -> Dict[str, object]:
    """``roofline.hlo.collective_overlap``'s counts on one pass of a
    rank's issue log (module doc): every permute started (the identity
    ones too, which XLA keeps), the block calls, and those inside at least
    one started and not yet awaited permute."""
    open_ids, windowed = set(), set()
    dots = overlapped = permutes = 0
    for event in issue_log:
        if event[-1] != phase:
            continue
        if event[0] == "start":
            permutes += 1
            open_ids.add(event[1])
        elif event[0] == "wait":
            open_ids.discard(event[1])
        elif event[0] == "block":
            dots += 1
            if open_ids:
                overlapped += 1
                windowed |= open_ids
    return {"overlap_fraction": overlapped / dots if dots else 0.0,
            "dots_total": dots, "dots_overlapped": overlapped,
            "permutes_total": permutes,
            "permutes_with_overlap_window": len(windowed)}


def _union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _covered(s: int, e: int, union: List[Tuple[int, int]]) -> int:
    return sum(max(0, min(e, b) - max(s, a)) for a, b in union)


def timed_overlap(events) -> Dict[str, float]:
    """The copies' share of device time under a kernel, from device
    events ``(name, stream, start_ns, end_ns)``. The permutes' copies are
    the device-to-device memcpys on streams that ran no kernel (the
    ranks' comm streams, where ``dist.comm`` queues nothing else); the
    kernels are every other event but memcpys, memsets and the device
    sleep that holds a queued run; the device is busy during any event
    but the sleep (the synchronous permutes' copies on the compute stream
    among them)."""
    kernels, copies, streams_with_kernels, busy = [], [], set(), []
    for name, stream, s, e in events:
        if "spin_kernel" in name:
            continue            # ``torch.cuda._sleep``: the queued run's hold
        busy.append((s, e))
        if name.startswith("Memcpy DtoD"):
            copies.append((stream, s, e))
        elif not name.startswith(("Memcpy", "Memset")):
            kernels.append((s, e))
            streams_with_kernels.add(stream)
    copies = [(s, e) for stream, s, e in copies
              if stream not in streams_with_kernels]
    under = _union(kernels)
    copy_ns = sum(e - s for s, e in copies)
    hidden_ns = sum(_covered(s, e, under) for s, e in copies)
    return {"timed_overlap_fraction": hidden_ns / copy_ns if copy_ns
            else 0.0,
            "copies": len(copies), "copy_ms": copy_ns / 1e6,
            "copy_hidden_ms": hidden_ns / 1e6,
            "kernel_ms": sum(e - s for s, e in kernels) / 1e6,
            "device_busy_ms": sum(e - s for s, e in _union(busy)) / 1e6}


def _sleep_cycles_per_s(device) -> float:
    """``torch.cuda._sleep``'s cycles per second on ``device``, from CUDA
    events around one sleep."""
    cycles = 10_000_000
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(torch.cuda.current_stream(device))
    torch.cuda._sleep(cycles)
    end.record(torch.cuda.current_stream(device))
    end.synchronize()
    return cycles / (start.elapsed_time(end) / 1e3)


def _device_events(prof):
    """(name, stream, start_ns, end_ns) of every device event of a
    finished ``torch.profiler`` window (its raw events)."""
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == torch.autograd.DeviceType.CUDA:
            yield (evt.name(), evt.device_resource_id(), evt.start_ns(),
                   evt.start_ns() + evt.duration_ns())


def overlap_report(cfg: ModelConfig, plan, *, batch: int = 1,
                   seq_len: Optional[int] = None, registry=None,
                   device=None, dtype: torch.dtype = torch.bfloat16
                   ) -> Dict[str, object]:
    """The comm/compute overlap of the plan's attention (module doc): one
    attention layer's forward and backward (the plan's scheme, issue order
    and ring chunks; causal; seeded random q, k, v, dO of ``dtype``) on a
    ``ThreadMesh(plan.c, plan.r)`` on ``device`` (default: the CUDA card).

    The JAX report's keys describe the forward, as the JAX island is one:
    ``overlap_fraction``, ``dots_total``, ``dots_overlapped``,
    ``permutes_total``, ``permutes_with_overlap_window`` (rank 0's issue
    log, ``issue_overlap``), ``ring_scope_instructions``,
    ``arrangement`` and ``shape``. ``backward`` holds the same counts for
    the backward, ``ranks_agree`` whether every rank counted the same.
    On CUDA the run is made twice in one ``torch.profiler`` window (call
    it warm): as the host paces it (``timed``: ``timed_overlap_fraction``, forward
    and backward, the copies' and kernels' device ms, the device's busy
    ms and the run's ``wall_s``), then queued whole behind a device sleep
    longer than the first run's wall time, so the card runs it back to
    back as when the host keeps ahead (``timed_queued``, the same fields
    and ``host_ahead``: whether the device was still busy when the last
    rank had issued its work). On the CPU both are None (not measured).
    With ``registry`` the
    ``attention_overlap_fraction`` gauge gets ``overlap_fraction`` under
    the JAX labels.
    """
    from repro_torch.core import startrail as st
    from repro_torch.core import ulysses as ul
    from repro_torch.dist.comm import ThreadMesh
    from repro_torch.engine.engine import resolve_device

    device = resolve_device(device)
    n = seq_len or plan.seq_len
    st_cfg = st.StarTrailConfig(
        seq_len=n, seq_scheme=plan.seq_scheme, causal=True,
        block_impl=plan.block_impl, comm_chunks=plan.comm_chunks,
        pipeline=plan.pipeline_scan)
    attention = (ul.ulysses_attention if plan.scheme == "ulysses"
                 else st.startrail_attention)
    s_local = n // plan.sp_size
    heads = (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads,
             cfg.num_heads)
    mesh = ThreadMesh(plan.c, plan.r, placement=plan.placement)

    def rank_fn(comm):
        g = torch.Generator(device=device).manual_seed(comm.rank)
        q, k, v, do = (torch.randn((batch, s_local, h, cfg.head_dim_),
                                   generator=g, device=device).to(dtype)
                       for h in heads)
        for t in (q, k, v):
            t.requires_grad_()
        attention(q, k, v, st_cfg, comm).backward(do)
        return comm.issue_log

    timed = queued = None
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        cycles_per_s = _sleep_cycles_per_s(device)
        # one profiler window: the host-paced run, then the queued one
        # behind the only sleep of the window, its events told apart by
        # the sleep's end
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            logs = mesh.run(rank_fn)
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
            t0 = time.perf_counter()
            torch.cuda._sleep(int(1.5 * wall * cycles_per_s))
            mesh.run(rank_fn)
            ahead = not torch.cuda.current_stream(device).query()
            torch.cuda.synchronize(device)
            wall_queued = time.perf_counter() - t0
        events = list(_device_events(prof))
        held = max(e for name_, _, _, e in events if "spin_kernel" in name_)
        timed = dict(timed_overlap([e for e in events if e[3] <= held]),
                     wall_s=wall, device=name)
        queued = dict(timed_overlap([e for e in events if e[2] >= held]),
                      wall_s=wall_queued, host_ahead=ahead, device=name)
    else:
        logs = mesh.run(rank_fn)
    fwd = [issue_overlap(log, "forward") for log in logs]
    bwd = [issue_overlap(log, "backward") for log in logs]
    report = {
        "ring_scope_instructions": ring_scope_counts(logs[0]),
        "arrangement": {"scheme": plan.scheme, "c": plan.c, "r": plan.r,
                        "sp": plan.sp_size, "placement": plan.placement,
                        "seq_scheme": plan.seq_scheme,
                        "pipeline_scan": plan.pipeline_scan,
                        "comm_chunks": plan.comm_chunks},
        "shape": {"batch": batch, "seq_len": n},
        **fwd[0],
        "backward": dict(bwd[0], ring_scope_instructions=ring_scope_counts(
            logs[0], "backward")),
        "ranks_agree": all(f == fwd[0] for f in fwd)
        and all(b == bwd[0] for b in bwd),
        "timed_overlap_fraction": (timed["timed_overlap_fraction"]
                                   if timed else None),
        "timed": timed,
        "timed_queued": queued,
    }
    if registry is not None:
        registry.gauge(
            "attention_overlap_fraction",
            "Share of the attention forward's block-kernel calls issued "
            "inside a ring transfer's start->wait window (the port's "
            "count of the JAX gauge's dot instructions)",
        ).set(report["overlap_fraction"], scheme=plan.scheme, c=str(plan.c),
              pipeline=str(plan.pipeline_scan),
              comm_chunks=str(plan.comm_chunks))
    return report


class CommLog:
    """Registry-backed per-train-step communication accounting.

    Prices the plan's per-layer analytical wire volumes once (in the
    model's parameter dtype), then ``record_step`` ticks
    ``comm_bytes_total{collective=...}`` counters: host-side dict adds
    only. The forward + backward multiplier is 3, the JAX module's
    train-step convention. ``record_ledger`` adds what a step's
    communicator measured, by kind and pass: the whole step (embedding and
    vocab collectives and the gradient reduction too), and under
    ``remat='attn_out'`` both runs of each attention forward, the
    recompute's included, under 'forward'.
    """

    TRAIN_STEP_MULTIPLIER = 3

    def __init__(self, registry, cfg: ModelConfig, plan, *,
                 batch: Optional[int] = None, train: bool = True):
        b = batch if batch is not None else plan.global_batch
        per_layer = analytical_wire_volumes(
            cfg, plan, batch=max(b, 1),
            dtype_bytes=_DTYPE_BYTES[cfg.param_dtype])
        layers = cost.num_attention_layers(cfg)
        mult = self.TRAIN_STEP_MULTIPLIER if train else 1
        self._per_step = {kind: v * layers * mult
                          for kind, v in per_layer.items()}
        self._counter = registry.counter(
            "comm_bytes_total",
            "Analytical per-device bytes per collective kind, accumulated "
            "per step (plan/cost eqs. 2-4 at the resolved arrangement)")
        self._steps = registry.counter(
            "comm_steps_total", "Steps priced by the comm log")
        self._measured = registry.counter(
            "comm_ledger_bytes_total",
            "Per-device wire bytes per collective kind and pass, as the "
            "communicator's ledger counted them")

    @property
    def per_step(self) -> Dict[str, float]:
        return dict(self._per_step)

    def record_step(self, n: int = 1) -> None:
        for kind, v in self._per_step.items():
            if v:
                self._counter.inc(v * n, collective=kind)
        self._steps.inc(n)

    def record_ledger(self, ledger: CommLedger) -> None:
        for phase, by_kind in ledger.bytes.items():
            for kind, v in by_kind.items():
                if v:
                    self._measured.inc(v, collective=kind, **{"pass": phase})
