"""Communication Topology Scheduler (paper §3.4; the port of
``repro.core.scheduler``).

Grid-searches the StarTrail tuning space

    Config = argmax_{C, placement} Profile(C in [1, sqrt(P)],
                                           placement in {P2P_intra, Collect_intra})

The paper profiles a few iterations on the real cluster; ``Profile``
defaults to the analytic cost model below (the paper's eqs. 2-4 plus an
overlap model) on the card's constants (``roofline.hw``: H100 datasheet
figures). Pass ``profile_fn`` that wall-clocks the step to search on
measurements instead (``plan.autotune`` does so through the trainer's
step): the search is identical.

Cost model for one attention block over sequence N, hidden H, P devices,
attention-parallel size C (bf16, bytes):

    collective (team gather + reduce-scatter):  4*B*N*H*(C-1)/P      (eq. 3)
    ring P2P total:                             2*B*N*kvH/C          (eq. 4)
    ring steps:                                 P / C^2
    attention compute per device:               2 * (2*N^2*Hq*dh/P)  flops

Overlap: per ring step, the transfer can hide under the block compute.
The model is parameterized by an overlap fraction f (default 1.0 =
perfect hiding) and by ``comm_chunks`` n (sub-chunked transfers: the
exposed wire time divides by n, the per-step message latency multiplies
by n). At f=1, n=1 the exposed time per step is max(compute_step,
wire_step) + latency. f cannot be measured on one card: the ranks of a
``dist.comm.ThreadMesh`` exchange synchronously, so nothing overlaps, and
the port's planner leaves f at 1.0. The placement decides which axis gets the
fast links: 'team_inner' (Collect_intra) gives the team collectives the
short hops; 'ring_inner' (P2P_intra) favours the ring transfers. It is
modelled as a bandwidth discount on the other class (the paper's
inter/intra-node distinction).

The formulas are the JAX module's, term for term and in the same order,
so that under equal constants the floats are the same.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core.topology import valid_c_values
from repro_torch.roofline import hw


@dataclasses.dataclass(frozen=True)
class AttnWorkload:
    batch: int
    seq_len: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    causal: bool = True
    dtype_bytes: int = 2


@dataclasses.dataclass(frozen=True)
class ClusterModel:
    sp_size: int
    peak_flops: float = hw.PEAK_FLOPS_BF16
    link_bw: float = hw.NVLINK_BW
    # hop-distance discount for the non-favoured collective class
    far_penalty: float = 2.0
    step_latency: float = 1e-6


def attention_step_cost(w: AttnWorkload, cl: ClusterModel, c: int,
                        placement: str, *, overlap_frac: float = 1.0,
                        comm_chunks: int = 1) -> Dict[str, float]:
    """Analytic per-block cost (seconds) for attention-parallel size c.

    ``overlap_frac`` f is the fraction of each ring transfer's wire time
    that hides under the block compute (1.0 = perfect hiding).
    ``comm_chunks`` n splits each transfer into n sub-chunk messages: the
    exposed wire time shrinks ~n-fold, at the price of n per-message
    latencies. Chunking therefore wins on bandwidth-bound shapes (large
    transfers, low f) and loses on latency-bound ones.
    """
    if not 0.0 <= overlap_frac <= 1.0:
        raise ValueError(f"overlap_frac must be in [0, 1], "
                         f"got {overlap_frac}")
    if comm_chunks < 1:
        raise ValueError(f"comm_chunks must be >= 1, got {comm_chunks}")
    p = cl.sp_size
    r = p // (c * c)
    causal_frac = 0.5 if w.causal else 1.0

    # compute: each device computes Q_team (c*N/p) x (N/c) of keys
    flops = (4.0 * w.batch * (c * w.seq_len / p) * (w.seq_len / c)
             * w.num_heads * w.head_dim * causal_frac)
    t_compute = flops / cl.peak_flops

    kv_h = w.num_kv_heads * w.head_dim
    q_h = w.num_heads * w.head_dim
    # collective: all-gather q,k,v + reduce-scatter o over the team (eq. 3)
    coll_bytes = (w.batch * w.seq_len / p * (c - 1)
                  * (2 * kv_h + 2 * q_h) * w.dtype_bytes)
    # ring: r-1 steps of the team's K/V chunk (eq. 4 without the setup hop)
    ring_step_bytes = 2 * w.batch * (c * w.seq_len / p) * kv_h * w.dtype_bytes
    ring_bytes = ring_step_bytes * max(r - 1, 0)

    bw_coll = cl.link_bw
    bw_ring = cl.link_bw
    if placement == "team_inner":     # collectives on the short hops
        bw_ring = cl.link_bw / cl.far_penalty
    else:                              # rings on the short hops
        bw_coll = cl.link_bw / cl.far_penalty

    t_coll = coll_bytes / bw_coll
    t_wire_step = ring_step_bytes / bw_ring
    t_lat_step = comm_chunks * cl.step_latency
    t_compute_step = t_compute / max(r, 1)
    # per-step overlap of the transfer with the block compute: a fraction
    # overlap_frac of the wire time (up to the compute available) hides;
    # the exposed remainder is pipelined across the comm_chunks sub-chunk
    # transfers (compute on chunk 0 overlaps the wire of chunks 1..n)
    hidden = overlap_frac * min(t_wire_step, t_compute_step)
    t_step_exposed = (t_compute_step + (t_wire_step - hidden) / comm_chunks
                      + t_lat_step)
    t_ring_exposed = max(r - 1, 0) * t_step_exposed
    t_ring_exposed += t_compute_step  # last step has no transfer to hide
    t_ring_step = t_wire_step + t_lat_step
    # team collectives overlap with the qkv matmuls only partially (paper:
    # "up to two-thirds"); expose one third
    t_total = t_ring_exposed + t_coll / 3.0

    return {
        "c": c, "placement": placement, "total_s": t_total,
        "compute_s": t_compute, "collective_bytes": coll_bytes,
        "ring_bytes": ring_bytes, "ring_steps": r,
        "compute_step_s": t_compute_step, "ring_step_s": t_ring_step,
        "overlap_frac": overlap_frac, "comm_chunks": comm_chunks,
    }


def choose_comm_chunks(w: AttnWorkload, cl: ClusterModel, c: int,
                       placement: str, *, overlap_frac: float = 1.0,
                       grid: Tuple[int, ...] = (1, 2, 4)) -> int:
    """Smallest-cost comm_chunks under the overlap model (ties -> fewer
    chunks: every extra chunk is an extra message to schedule)."""
    best = min(grid, key=lambda n: (attention_step_cost(
        w, cl, c, placement, overlap_frac=overlap_frac,
        comm_chunks=n)["total_s"], n))
    return int(best)


def schedule(w: AttnWorkload, cl: ClusterModel,
             profile_fn: Optional[Callable[[int, str], float]] = None
             ) -> Dict[str, object]:
    """Grid search; returns the best config + the full grid (paper eq. 8).
    ``profile_fn(c, placement)`` -> seconds replaces the analytic cost."""
    grid = []
    for c in valid_c_values(cl.sp_size):
        for placement in ("team_inner", "ring_inner"):
            if profile_fn is not None:
                cost = {"c": c, "placement": placement,
                        "total_s": profile_fn(c, placement)}
            else:
                cost = attention_step_cost(w, cl, c, placement)
            grid.append(cost)
    best = min(grid, key=lambda g: g["total_s"])
    return {"best": best, "grid": grid}
