"""Analytical cost model for communication arrangements (the port of
``repro.plan.cost``; paper eqs. 2-4).

At a sequence-parallel degree P there is a family of arrangements: the
StarTrail (C, R) factorisations with P = C^2 * R and either axis
placement, the plain ring (C = 1), and DeepSpeed-Ulysses' all-to-all
scheme, legal only while the head counts divide P (the limit
``core.ulysses`` enforces).

The scheme half enumerates them and prices one attention layer's forward
per device in bytes (``comm_volumes``, a faithful copy of the JAX
function; ``obs.commlog`` holds the communicator's measured bytes against
it). The time half prices them in seconds through ``core.scheduler``'s
overlap model on the card's constants (``roofline.hw``) and ranks them
(``rank_arrangements``); ``plan.make_plan`` turns the first legal match
into an ``ExecutionPlan`` and ``plan.autotune`` refines the top of the
ranking with measured steps. The serving half prices one prefill with
part of its prompt cached (``prefill_step_cost``: the engine's eviction
ranking), one decode step (``decode_step_cost``, B4 as the JAX model's
'pallas' row), a request's TTFT at admission (``serve_slo_cost``: the
front end's SLO gate), a prefix cache's value (``prefix_cache_value``:
``launch.serve``'s gateway mode), and the host KV tier's spill against
recompute (``kv_transfer_cost``, ``spill_decision``) over the card's host
link. ``rank_decode_kernels`` sorts both decode kernels fastest first,
``chunked_prefill_cost`` prices a chunked prefill against the monolithic
one, and ``spill_threshold_tokens`` finds the chain length from which a
spill beats recompute. Every formula is the JAX one's, so under equal
constants the numbers are the same. The microbatch half
(``activation_bytes_per_microbatch``, ``choose_microbatches``) picks a
production training plan's microbatch count against a share of the
card's memory (``hw.HBM_BYTES``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import scheduler as sch
from repro_torch.core.topology import valid_c_values
from repro_torch.roofline import hw

SCHEMES = ("startrail", "ring", "ulysses")


@dataclasses.dataclass(frozen=True)
class Arrangement:
    """One point of the (scheme, C, placement) tuning space at fixed P."""

    scheme: str                 # 'startrail' | 'ring' (C=1) | 'ulysses'
    c: int
    r: int
    placement: str = "team_inner"

    @property
    def key(self) -> str:
        if self.scheme == "startrail":
            return f"startrail_c{self.c}_{self.placement}"
        return self.scheme


def num_attention_layers(cfg: ModelConfig) -> int:
    n = sum(1 for i in range(cfg.num_layers)
            if cfg.mixer_on_layer(i) == "attn")
    if cfg.encdec:
        n += cfg.num_encoder_layers + cfg.num_layers  # self + cross attention
    return n


def ulysses_supported(cfg: ModelConfig, sp: int) -> bool:
    """Ulysses heads-divisibility limit: SP must divide Hq and Hkv."""
    return cfg.num_heads % sp == 0 and cfg.num_kv_heads % sp == 0


def check_scheme(cfg: ModelConfig, sp: int, scheme: str) -> None:
    """Raise (with the wording of ``core.ulysses``) for illegal schemes."""
    if scheme not in SCHEMES:
        raise ValueError(f"scheme must be one of {SCHEMES}, got {scheme!r}")
    if scheme == "ulysses" and not ulysses_supported(cfg, sp):
        raise ValueError(
            f"Ulysses requires head counts divisible by SP degree: "
            f"Hq={cfg.num_heads}, Hkv={cfg.num_kv_heads}, SP={sp} "
            f"(the paper's scalability limit)")


def enumerate_arrangements(cfg: ModelConfig, sp: int) -> List[Arrangement]:
    """All legal arrangements at sequence-parallel degree ``sp``."""
    out: List[Arrangement] = []
    for c in valid_c_values(sp):
        r = sp // (c * c)
        if c == 1:
            out.append(Arrangement("ring", 1, r))
        else:
            for placement in ("team_inner", "ring_inner"):
                out.append(Arrangement("startrail", c, r, placement))
    if ulysses_supported(cfg, sp):
        out.append(Arrangement("ulysses", 1, sp))
    return out


def comm_volumes(cfg: ModelConfig, shape: ShapeConfig, sp: int,
                 arr: Arrangement, *, batch: Optional[int] = None,
                 dtype_bytes: int = 2) -> Dict[str, float]:
    """Per-device bytes for one attention layer's forward.

    StarTrail (paper eqs. 3-4, with the JAX implementation's R ring
    permutes: the chunks tour the full ring so the backward reuses the
    placement):

      team all-gather:    (C-1) * B * N/P * (Hq + 2*Hkv) * dh * bytes
      placement ppermute: 2 * B * (C*N/P) * Hkv * dh * bytes      (Alg. 2)
      sub-ring ppermute:  R  * [the same chunk]                   (eq. 4)
      reduce-scatter:     (C-1) * B * N/P * Hq * dh * 4           (f32 combine)

    Ring is the C=1 point (no team collectives). Ulysses is the two
    all-to-all pairs: q/k/v seq->head then o head->seq, each moving
    (P-1)/P of the local tensor.
    """
    b = shape.global_batch if batch is None else batch
    n = shape.seq_len
    dh = cfg.head_dim_
    q_h = cfg.num_heads * dh
    kv_h = cfg.num_kv_heads * dh
    s_local = n / sp
    c, r = arr.c, arr.r

    if arr.scheme == "ulysses":
        a2a = (sp - 1) / sp * b * s_local * (2 * q_h + 2 * kv_h) * dtype_bytes
        return {"team_allgather": 0.0, "placement_p2p": 0.0,
                "ring_p2p": 0.0, "combine_rs": 0.0, "all_to_all": a2a,
                "total": a2a}

    chunk = 2 * b * (c * s_local) * kv_h * dtype_bytes   # one team's K/V
    vols = {
        "team_allgather": (c - 1) * b * s_local * (q_h + 2 * kv_h)
        * dtype_bytes,
        "placement_p2p": chunk if c > 1 else 0.0,
        "ring_p2p": r * chunk,
        "combine_rs": (c - 1) * b * s_local * q_h * 4.0,
        "all_to_all": 0.0,
    }
    vols["total"] = sum(vols.values())
    return vols


# ---------------------------------------------------------------------------
# Time model (delegates to the §3.4 scheduler for ring/startrail)
# ---------------------------------------------------------------------------

def _workload(cfg: ModelConfig, shape: ShapeConfig,
              batch: int) -> sch.AttnWorkload:
    return sch.AttnWorkload(
        batch=max(batch, 1), seq_len=shape.seq_len, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim_,
        causal=(cfg.prefix_len_frac == 0.0))


def arrangement_time(cfg: ModelConfig, shape: ShapeConfig, sp: int,
                     arr: Arrangement, *, batch: Optional[int] = None,
                     cluster: Optional[sch.ClusterModel] = None,
                     overlap_frac: float = 1.0,
                     comm_chunks: int = 1) -> float:
    """Estimated seconds for one attention layer under ``arr``: the ring
    schemes through ``core.scheduler.attention_step_cost`` at
    ``overlap_frac`` (the share of each ring transfer the block kernels
    hide; pass the measured one from ``obs.commlog.overlap_report``) and
    ``comm_chunks`` sub-chunks a transfer, Ulysses as compute plus its
    all-to-alls."""
    b = shape.global_batch if batch is None else batch
    w = _workload(cfg, shape, b)
    cl = cluster or sch.ClusterModel(sp_size=sp)
    if arr.scheme in ("ring", "startrail"):
        return sch.attention_step_cost(
            w, cl, arr.c, arr.placement, overlap_frac=overlap_frac,
            comm_chunks=comm_chunks)["total_s"]
    # Ulysses: fully-local attention between two all-to-all pairs; the
    # all-to-alls cannot overlap with the attention itself.
    vols = comm_volumes(cfg, shape, sp, arr, batch=b,
                        dtype_bytes=w.dtype_bytes)
    causal_frac = 0.5 if w.causal else 1.0
    flops = 4.0 * w.batch * w.seq_len * w.seq_len * w.num_heads \
        * w.head_dim * causal_frac / sp
    return flops / cl.peak_flops + vols["all_to_all"] / cl.link_bw \
        + 2 * cl.step_latency


def rank_arrangements(cfg: ModelConfig, shape: ShapeConfig, sp: int, *,
                      batch: Optional[int] = None,
                      cluster: Optional[sch.ClusterModel] = None,
                      arrangements: Optional[Sequence[Arrangement]] = None,
                      overlap_frac: float = 1.0,
                      comm_chunks: int = 1,
                      ) -> List[Dict[str, object]]:
    """All legal arrangements (or ``arrangements``) priced and sorted
    fastest-first, the ring schemes at ``overlap_frac`` and
    ``comm_chunks`` (``arrangement_time``).

    Each entry: {"arrangement": Arrangement, "total_s": float,
    "volumes": per-layer byte breakdown, "model_s": whole-model estimate}.
    """
    cands = list(arrangements) if arrangements is not None \
        else enumerate_arrangements(cfg, sp)
    n_attn = max(num_attention_layers(cfg), 1)
    out = []
    for arr in cands:
        t = arrangement_time(cfg, shape, sp, arr, batch=batch,
                             cluster=cluster, overlap_frac=overlap_frac,
                             comm_chunks=comm_chunks)
        out.append({
            "arrangement": arr,
            "total_s": t,
            "model_s": t * n_attn,
            "volumes": comm_volumes(cfg, shape, sp, arr, batch=batch),
        })
    out.sort(key=lambda e: e["total_s"])
    return out


def choose_comm_chunks(cfg: ModelConfig, shape: ShapeConfig, sp: int,
                       arr: Arrangement, *, batch: Optional[int] = None,
                       cluster: Optional[sch.ClusterModel] = None,
                       overlap_frac: float = 1.0,
                       grid: Sequence[int] = (1, 2, 4)) -> int:
    """Resolve the ring-transfer sub-chunk count for one arrangement.

    Argmin of the overlap model at ``overlap_frac`` over ``grid``,
    constrained to chunk counts that divide the per-device team sequence
    length (c * N / P, the axis ``core.startrail._RingTransfer`` splits).
    Non-ring schemes have no transfers to chunk -> 1.
    """
    if arr.scheme not in ("ring", "startrail"):
        return 1
    s_team = arr.c * shape.seq_len // sp
    legal = tuple(n for n in grid if n >= 1 and s_team % n == 0) or (1,)
    b = shape.global_batch if batch is None else batch
    w = _workload(cfg, shape, b)
    cl = cluster or sch.ClusterModel(sp_size=sp)
    return sch.choose_comm_chunks(w, cl, arr.c, arr.placement,
                                  overlap_frac=overlap_frac, grid=legal)


# ---------------------------------------------------------------------------
# Serving prefill cost and the host-tier spill/reload pricing
# ---------------------------------------------------------------------------

def prefill_step_cost(cfg: ModelConfig, *, prompt_len: int,
                      cached_len: int = 0, sp: int = 1,
                      page_size: int = 8, dtype_bytes: int = 2,
                      cluster: Optional[sch.ClusterModel] = None
                      ) -> Dict[str, float]:
    """Per-device cost of prefilling one request with ``cached_len`` of its
    prompt served from the prefix cache.

    Only the suffix tokens are forwarded: dense/MLP FLOPs scale linearly in
    forwarded tokens (``2 * P_dense`` per token), attention quadratically
    (suffix queries still score the cached keys, reading them from the
    pool, but never recompute their K/V or their own rows). What a cached
    token costs is the page-pool read of its K/V during the suffix's
    attention plus the page-table writes (int32 per block), so cached
    tokens are priced in bytes, not FLOPs.

    Returns {'flops', 'bytes', 'total_s', 'flops_saved', 'saved_frac'}:
    ``total_s`` the larger of the FLOP time and the byte time,
    ``saved_frac`` the fraction of the cold prefill's FLOPs the cache
    removed.
    """
    if not 0 <= cached_len <= prompt_len:
        raise ValueError(f"cached_len={cached_len} outside "
                         f"[0, {prompt_len}]")
    cl = cluster or sch.ClusterModel(sp_size=sp)
    n_attn = max(num_attention_layers(cfg), 1)
    dh = cfg.head_dim_
    d = cfg.d_model
    # dense params touched per token per layer (qkv/o + mlp), vocab head off
    dense_per_layer = d * dh * (cfg.num_heads * 2 + cfg.num_kv_heads * 2) \
        + 3 * d * cfg.d_ff

    def attn_flops(q_tokens: int, k_tokens_extra: int) -> float:
        # causal suffix scores ~ q*(q/2) within itself + q*cached keys
        return 4.0 * cfg.num_heads * dh * (
            q_tokens * q_tokens / 2.0 + q_tokens * k_tokens_extra)

    suffix = prompt_len - cached_len
    flops_cold = (2.0 * dense_per_layer * prompt_len * cfg.num_layers
                  + n_attn * attn_flops(prompt_len, 0)) / sp
    flops = (2.0 * dense_per_layer * suffix * cfg.num_layers
             + n_attn * attn_flops(suffix, cached_len)) / sp
    # cached K/V read once by the suffix attention; page-table writes are
    # one int32 per (shard, block)
    cached_blocks = cached_len // max(page_size, 1)
    bytes_moved = n_attn * (2.0 * cached_len * cfg.num_kv_heads * dh
                            * dtype_bytes) / sp + 4.0 * cached_blocks
    flops_s = flops / cl.peak_flops
    bytes_s = bytes_moved / hw.HBM_BW
    return {"flops": flops, "bytes": bytes_moved,
            "total_s": max(flops_s, bytes_s),
            "flops_saved": flops_cold - flops,
            "saved_frac": 1.0 - flops / flops_cold if flops_cold else 0.0}


def chunked_prefill_cost(cfg: ModelConfig, *, prompt_len: int,
                         cached_len: int = 0, chunk: int = 0, sp: int = 1,
                         page_size: int = 8, dtype_bytes: int = 2,
                         cluster: Optional[sch.ClusterModel] = None
                         ) -> Dict[str, object]:
    """A chunked prefill priced against the monolithic one.

    The engine's chunking rule: the chunk is rounded up to a power-of-two
    multiple of ``lcm(sp, page_size)``, and chunk ``k`` runs as a suffix
    prefill with ``cached_len`` the tokens already landed, so its
    attention re-reads the earlier chunks' K/V from the pool. Chunking
    costs total time (the re-reads, and the quadratic self-attention lost
    to the split) and buys latency: the longest single step shrinks from
    the whole prompt to one chunk, which bounds the decode stall a
    co-scheduled batch sees.

    Returns {'chunks' (each chunk's ``prefill_step_cost`` with its 'start'
    and 'end'), 'n_chunks', 'total_s', 'monolithic_s', 'overhead_frac',
    'max_step_s', 'monolithic_step_s'}; ``chunk=0`` is one chunk with no
    overhead.
    """
    if not 0 <= cached_len <= prompt_len:
        raise ValueError(f"cached_len={cached_len} outside "
                         f"[0, {prompt_len}]")
    base = math.lcm(sp, page_size)
    step = 0
    if chunk > 0:
        step = base
        while step < max(chunk, base):
            step *= 2
    bounds = []
    start = cached_len
    while start < prompt_len:
        end = prompt_len if not step else min(start + step, prompt_len)
        bounds.append((start, end))
        start = end
    if not bounds:                      # a fully cached prompt
        bounds = [(cached_len, prompt_len)]
    chunks = []
    for s, e in bounds:
        c = prefill_step_cost(cfg, prompt_len=e, cached_len=s, sp=sp,
                              page_size=page_size, dtype_bytes=dtype_bytes,
                              cluster=cluster)
        c["start"], c["end"] = s, e
        chunks.append(c)
    mono = prefill_step_cost(cfg, prompt_len=prompt_len,
                             cached_len=cached_len, sp=sp,
                             page_size=page_size, dtype_bytes=dtype_bytes,
                             cluster=cluster)
    total_s = sum(c["total_s"] for c in chunks)
    return {
        "chunks": chunks,
        "n_chunks": len(chunks),
        "total_s": total_s,
        "monolithic_s": mono["total_s"],
        "overhead_frac": (total_s / mono["total_s"] - 1.0
                          if mono["total_s"] else 0.0),
        "max_step_s": max(c["total_s"] for c in chunks),
        "monolithic_step_s": mono["total_s"],
    }


# the paged-decode kernels (``kernels.dispatch.IMPLS``); 'cuda' is the JAX
# model's 'pallas' row: one pass over the bucketed pages
DECODE_KERNELS = ("ref", "cuda")


def decode_step_cost(cfg: ModelConfig, *, batch: int, cache_len: int,
                     sp: int, page_size: int, kernel: str = "ref",
                     dtype_bytes: int = 2,
                     cluster: Optional[sch.ClusterModel] = None
                     ) -> Dict[str, float]:
    """Per-device cost of one decode step's attention, all layers.

    Decode is bandwidth-bound: the FLOPs (one query against the cache) are
    the same for both kernels, the bytes through HBM are not. Both walk
    the per-shard table width rounded up to a power of two (the JAX
    engine's buckets; the formula is the JAX one's): ``kernel='cuda'``
    (B4) reads each table-indexed K/V page once, ``'ref'`` makes three
    passes (read the pool pages, write a dense copy, read it into the
    attention).

    Returns {'flops', 'bytes', 'flops_s', 'bytes_s', 'total_s'} summed
    over the attention layers, ``total_s`` the larger of the two times.
    """
    if kernel not in DECODE_KERNELS:
        raise ValueError(f"kernel must be one of {DECODE_KERNELS}, "
                         f"got {kernel!r}")
    cl = cluster or sch.ClusterModel(sp_size=sp)
    n_attn = max(num_attention_layers(cfg), 1)
    dh = cfg.head_dim_
    keys_local = -(-cache_len // sp)                 # ceil: per-shard keys
    pages_local = -(-keys_local // page_size)
    w_bucket = 1
    while w_bucket < pages_local:
        w_bucket *= 2
    bucket_bytes = batch * w_bucket * page_size * 2 * cfg.num_kv_heads \
        * dh * dtype_bytes
    flops = 4.0 * batch * keys_local * cfg.num_heads * dh
    bytes_moved = bucket_bytes if kernel == "cuda" else 3.0 * bucket_bytes
    flops_s = n_attn * flops / cl.peak_flops
    bytes_s = n_attn * bytes_moved / hw.HBM_BW
    return {"flops": n_attn * flops, "bytes": n_attn * bytes_moved,
            "flops_s": flops_s, "bytes_s": bytes_s,
            "total_s": max(flops_s, bytes_s)}


def rank_decode_kernels(cfg: ModelConfig, *, batch: int, cache_len: int,
                        sp: int, page_size: int,
                        cluster: Optional[sch.ClusterModel] = None
                        ) -> List[Dict[str, object]]:
    """Both decode kernels priced and sorted fastest first ('cuda' is the
    JAX model's 'pallas')."""
    out = [{"kernel": k,
            **decode_step_cost(cfg, batch=batch, cache_len=cache_len,
                               sp=sp, page_size=page_size, kernel=k,
                               cluster=cluster)}
           for k in DECODE_KERNELS]
    out.sort(key=lambda e: e["total_s"])
    return out


def serve_slo_cost(cfg: ModelConfig, *, prompt_len: int,
                   queued_tokens: int = 0, sp: int = 1, page_size: int = 8,
                   decode_batch: int = 1, kernel: str = "ref",
                   cluster: Optional[sch.ClusterModel] = None
                   ) -> Dict[str, float]:
    """A request's TTFT and steady tokens/s for SLO-priced admission
    (``frontend.slo.SLOAdmission``): TTFT is this prompt's own cold
    prefill plus the time the replica takes to clear the
    ``queued_tokens`` committed ahead of it at the full-batch decode rate.

    Returns {'prefill_s', 'decode_step_s', 'queue_s', 'ttft_s',
    'tokens_per_s'} in analytical seconds (callers scale them to the
    measured machine with one factor).
    """
    prefill_s = prefill_step_cost(
        cfg, prompt_len=max(prompt_len, 1), sp=sp, page_size=page_size,
        cluster=cluster)["total_s"]
    decode_step_s = decode_step_cost(
        cfg, batch=max(decode_batch, 1),
        cache_len=max(prompt_len, page_size * sp), sp=sp,
        page_size=page_size, kernel=kernel, cluster=cluster)["total_s"]
    rate = max(decode_batch, 1) / max(decode_step_s, 1e-12)
    queue_s = queued_tokens / rate
    return {"prefill_s": prefill_s, "decode_step_s": decode_step_s,
            "queue_s": queue_s, "ttft_s": prefill_s + queue_s,
            "tokens_per_s": rate}


def prefix_cache_value(cfg: ModelConfig, *, prompt_len: int,
                       shared_len: int, requests: int, sp: int,
                       page_size: int, pages_per_shard: int,
                       max_len: int = 0,
                       cluster: Optional[sch.ClusterModel] = None
                       ) -> Dict[str, float]:
    """A prefix-cache capacity priced against the hit rate it can sustain:
    ``requests`` arrivals share a ``shared_len``-token prefix of their
    ``prompt_len`` prompts. The shared prefix's pages sit on top of one
    worst-case live request's; if the pool cannot hold both, every lookup
    misses. Otherwise the first request pays the cold prefill and each
    later one saves ``prefill_step_cost(..., cached_len=)`` of its own.

    Returns {'hit_rate', 'saved_tokens', 'saved_flops', 'saved_s',
    'cache_pages', 'fits'}.
    """
    shared_cacheable = (shared_len // page_size) * page_size
    cache_pages = -(-shared_cacheable // page_size)
    # worst-case per-shard pages of one live request: ceil blocks, then
    # ceil over the round-robin shards (Scheduler._blocks_for semantics)
    worst_blocks = -(-(prompt_len + (max_len or prompt_len)) // page_size)
    worst = -(-worst_blocks // sp)
    fits = (-(-cache_pages // sp)) + worst <= pages_per_shard
    if not fits or requests < 2 or shared_cacheable == 0:
        return {"hit_rate": 0.0, "saved_tokens": 0, "saved_flops": 0.0,
                "saved_s": 0.0, "cache_pages": cache_pages, "fits": fits}
    per = prefill_step_cost(cfg, prompt_len=prompt_len,
                            cached_len=shared_cacheable, sp=sp,
                            page_size=page_size, cluster=cluster)
    cold = prefill_step_cost(cfg, prompt_len=prompt_len, sp=sp,
                             page_size=page_size, cluster=cluster)
    warm = requests - 1
    return {"hit_rate": warm * shared_cacheable / (requests * prompt_len),
            "saved_tokens": warm * shared_cacheable,
            "saved_flops": warm * per["flops_saved"],
            "saved_s": warm * (cold["total_s"] - per["total_s"]),
            "cache_pages": cache_pages, "fits": fits}


def kv_bytes_per_token(cfg: ModelConfig, *, dtype_bytes: int = 2) -> int:
    """Bytes of K+V one token pins across all attention layers."""
    n_attn = max(num_attention_layers(cfg), 1)
    return n_attn * 2 * cfg.num_kv_heads * cfg.head_dim_ * dtype_bytes


def kv_transfer_cost(cfg: ModelConfig, *, tokens: int, dtype_bytes: int = 2,
                     link_bw: Optional[float] = None) -> Dict[str, float]:
    """Price moving ``tokens`` of KV over the device<->host link
    (``hw.HOST_LINK_BW`` unless ``link_bw`` is given).

    The pool is SP-sharded but the host link is per host, so the bytes are
    not divided by ``sp``. ``roundtrip_s`` is the spill (d2h) plus the
    eventual reload (h2d): what a host-tier hit pays instead of recompute.
    """
    bw = link_bw if link_bw is not None else hw.HOST_LINK_BW
    total = float(tokens) * kv_bytes_per_token(cfg, dtype_bytes=dtype_bytes)
    one_way = total / bw
    return {"bytes": total, "d2h_s": one_way, "h2d_s": one_way,
            "roundtrip_s": 2.0 * one_way}


def spill_decision(cfg: ModelConfig, *, chain_tokens: int, sp: int = 1,
                   page_size: int = 8, dtype_bytes: int = 2,
                   link_bw: Optional[float] = None,
                   cluster: Optional[sch.ClusterModel] = None
                   ) -> Dict[str, object]:
    """Should an evicted ``chain_tokens``-token prefix spill to host?

    Compares what a later miss would pay either way: recomputing the chain
    cold (``prefill_step_cost``: dense FLOPs linear in tokens, attention
    quadratic) against round-tripping its KV bytes over the host link
    (linear in tokens). Only recompute has a quadratic term, so short
    chains are faster to re-prefill and long ones faster to reload.

    Returns {'recompute_s', 'transfer_s', 'bytes', 'spill'}.
    """
    if chain_tokens <= 0:
        raise ValueError(f"chain_tokens must be positive, got {chain_tokens}")
    rec = prefill_step_cost(cfg, prompt_len=chain_tokens, sp=sp,
                            page_size=page_size, dtype_bytes=dtype_bytes,
                            cluster=cluster)
    xfer = kv_transfer_cost(cfg, tokens=chain_tokens,
                            dtype_bytes=dtype_bytes, link_bw=link_bw)
    return {"recompute_s": rec["total_s"],
            "transfer_s": xfer["roundtrip_s"],
            "bytes": xfer["bytes"],
            "spill": xfer["roundtrip_s"] < rec["total_s"]}


def spill_threshold_tokens(cfg: ModelConfig, *, sp: int = 1,
                           page_size: int = 8, max_tokens: int = 1 << 20,
                           dtype_bytes: int = 2,
                           link_bw: Optional[float] = None,
                           cluster: Optional[sch.ClusterModel] = None
                           ) -> Optional[int]:
    """The smallest page-multiple chain length for which spilling beats
    recompute, or None if no chain up to ``max_tokens`` does.

    recompute_s - transfer_s = a*t^2 + b*t with a > 0 (the attention
    term), so the decision is monotone in t: a binary search finds the
    first page boundary where it flips.
    """
    def spills(tokens: int) -> bool:
        return bool(spill_decision(
            cfg, chain_tokens=tokens, sp=sp, page_size=page_size,
            dtype_bytes=dtype_bytes, link_bw=link_bw,
            cluster=cluster)["spill"])

    lo, hi = 1, max_tokens // page_size          # in blocks
    if hi < 1 or not spills(hi * page_size):
        return None
    while lo < hi:
        mid = (lo + hi) // 2
        if spills(mid * page_size):
            hi = mid
        else:
            lo = mid + 1
    return lo * page_size


# ---------------------------------------------------------------------------
# Microbatch selection (gradient accumulation)
# ---------------------------------------------------------------------------

def activation_bytes_per_microbatch(cfg: ModelConfig, shape: ShapeConfig, *,
                                    dp: int, sp: int, c: int,
                                    microbatches: int,
                                    remat: str = "attn_out") -> float:
    """Rough per-device activation footprint of one microbatch's fwd+bwd:
    the residual-stream activations kept for the backward (d_model wide,
    bf16) per decoder layer, scaled by the recompute policy, plus the
    team-gathered attention working set (C * S_local wide). A planning
    heuristic; ``launch.dryrun``'s memory record is the measured figure."""
    act_factor = {"none": 12.0, "attn_out": 6.0, "full": 2.0}[remat]
    b_local = max(shape.global_batch // max(dp, 1), 1) / max(microbatches, 1)
    tokens = b_local * shape.seq_len / sp
    resid = tokens * cfg.d_model * 2.0 * cfg.num_layers * act_factor
    attn_ws = tokens * c * cfg.head_dim_ * (cfg.num_heads
                                            + 2 * cfg.num_kv_heads) * 4.0
    return resid + attn_ws


def choose_microbatches(cfg: ModelConfig, shape: ShapeConfig, *, dp: int,
                        sp: int, c: int = 1, remat: str = "attn_out",
                        hbm_budget: Optional[float] = None) -> int:
    """Smallest microbatch count dividing the per-device batch whose
    activation estimate fits ``hbm_budget`` (default 0.4 of the card's
    memory; the rest is parameters, optimizer state and temporaries)."""
    if shape.kind != "train":
        return 1
    if hbm_budget is None:
        hbm_budget = 0.4 * hw.HBM_BYTES
    b_local = max(shape.global_batch // max(dp, 1), 1)
    for m in range(1, b_local + 1):
        if b_local % m:
            continue
        if activation_bytes_per_microbatch(
                cfg, shape, dp=dp, sp=sp, c=c, microbatches=m,
                remat=remat) <= hbm_budget:
            return m
    return b_local
