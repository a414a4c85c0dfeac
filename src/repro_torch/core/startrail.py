"""StarTrail concentric-ring sequence-parallel attention, with its backward.

Port of ``repro.core.startrail`` (lines 114-131, 238-449, 481-531). The SP
dimension P is factored onto the axes ``(sp_grp = C, sp_ring = R,
sp_team = C)``, P = C^2 * R, and exact full-sequence attention of a
sequence sharded over them is computed per rank as:

  1. all_gather Q/K/V over ``sp_team``            (team gather)
  2. one ppermute over the joint SP axes with the Alg.-2 placement
     permutation                                   (initial K/V dispatch)
  3. R ring steps: block attention merged into the running (o, lse)
     accumulator, which starts empty (o = 0, lse = -1e30), through
     ``dispatch.block_fwd_merge`` (the B2 kernel on 'cuda'), then a
     ppermute of K/V along ``sp_ring``
  4. log-sum-exp combine across ``sp_team`` plus reduce-scatter

The backward is the paper's two-loop scheme: the placement-ordered K/V and
their gradients stay resident, while the (Q, dO, delta, lse, dQ) pack
circulates the ring through ``dispatch.block_bwd`` (the B3 kernel on
'cuda'); then the inverse placement permute and team reduce-scatters.

``startrail_forward`` and ``startrail_backward`` are the plain per-rank
functions; ``StarTrailAttention`` is the ``torch.autograd.Function`` over
them, and ``startrail_attention`` applies it. Collectives go through a
``dist.comm`` communicator (``SingleComm`` at P = 1, where they are
identities; ``ThreadMesh`` for P > 1 in one process). Masks come from global
token positions computed from the rank coordinates.

``comm_chunks = n`` (``StarTrailConfig``, the JAX knob) splits each ring
transfer into n sequence sub-chunks: n transfers of the same bytes, whose
values equal the unsplit ring's bit for bit.

``pipeline`` (the JAX knob, on by default) sets the ring's issue order.
On, the forward starts step s+1's K/V transfer (``dist.comm``'s
``ppermute_start``) before step s's block kernel and waits for it after,
and the backward starts the (q, do, delta, lse) pack's transfer before the
step's ``block_bwd`` and sends ``dq`` after it; on a CUDA card the copy
runs on the rank's comm stream while the block kernel runs on its compute
stream, which is the overlap the paper's ring is built for. Off, each step
computes and then transfers. Both orders run the same kernels on the same
inputs, and every kernel here is deterministic (``csrc/flash_fwd.cuh``,
``csrc/flash_bwd.cuh``), so they give the same bits; the pipelined one
keeps a second K/V (or pack) alive during the block kernel. The transfers
sit in a ``ring_permute_issue`` scope and the block kernels in a
``ring_block_compute`` one, the JAX scope names: each is a
``torch.profiler`` range, and a ``ThreadMesh`` rank notes each scope and
each block call in its issue log (``obs.commlog.overlap_report``).

Differences from the JAX module: the forward makes R-1 ring transfers, not
R: its last step does not rotate K/V back into placement order (the
residuals keep the placement-ordered K/V from before the loop), and at
C = 1 the placement permutation is the identity and moves nothing; the
circulating pack's team index is computed from the step, not sent.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import topology as topo_lib
from repro_torch.core.combine import NEG_INF
from repro_torch.kernels import dispatch as kernels
from repro_torch.obs.tracing import _trace_annotation


@dataclasses.dataclass(frozen=True)
class StarTrailConfig:
    """Static configuration of the concentric-ring attention.

    seq_len: global sequence length N. axes: (sp_grp, sp_ring, sp_team).
    seq_scheme: 'zigzag' (causal load balance) or 'contiguous'. causal /
    window / prefix_len: the mask. block_impl: 'ref' | 'cuda'.
    block_skip: skip ring steps whose block is fully masked. comm_chunks:
    split each ring transfer into this many sequence sub-chunks (no value
    changes). pipeline: issue each ring transfer before the block kernel
    that does not need it (module doc; no value changes).
    """

    seq_len: int
    axes: Tuple[str, str, str] = ("sp_grp", "sp_ring", "sp_team")
    seq_scheme: str = "zigzag"
    causal: bool = True
    window: Optional[int] = None
    scale: Optional[float] = None
    prefix_len: Optional[int] = None
    block_impl: str = "ref"
    block_skip: bool = False
    comm_chunks: int = 1
    pipeline: bool = True


# ---------------------------------------------------------------------------
# position bookkeeping
# ---------------------------------------------------------------------------

def shard_positions(sp_rank: int, seq_len: int, sp_size: int, scheme: str,
                    device=None) -> torch.Tensor:
    """Global positions of SP shard ``sp_rank`` -> (S_local,) int32.

    'contiguous' gives shard p the p-th of P equal slices. 'zigzag' (the
    causal load balance of StarTrail/WallFacer §3.5) splits the sequence
    into 2P chunks and gives shard p chunks p and 2P-1-p, so every shard
    owns one early and one late chunk."""
    s_local = seq_len // sp_size
    if scheme == "contiguous":
        if seq_len % sp_size:
            raise ValueError(f"seq_len={seq_len} % sp_size={sp_size} != 0")
        return sp_rank * s_local + torch.arange(s_local, dtype=torch.int32,
                                                device=device)
    if scheme == "zigzag":
        if seq_len % (2 * sp_size):
            raise ValueError(f"seq_len={seq_len} must be divisible by "
                             f"2*sp_size={2 * sp_size}")
        ch = seq_len // (2 * sp_size)
        ar = torch.arange(ch, dtype=torch.int32, device=device)
        return torch.cat([sp_rank * ch + ar,
                          (2 * sp_size - 1 - sp_rank) * ch + ar])
    raise ValueError(f"unknown seq scheme {scheme!r}")


def team_positions(team_idx: int, c: int, seq_len: int, sp_size: int,
                   scheme: str, device=None) -> torch.Tensor:
    """Positions of the C concatenated member shards of team ``team_idx``."""
    return torch.cat([shard_positions(team_idx * c + i, seq_len, sp_size,
                                      scheme, device) for i in range(c)])


def fully_masked(cfg: StarTrailConfig, pos_q, pos_k) -> bool:
    """True iff the whole (Q block x K block) pair is masked out (host
    decision: positions are computed on the host, see ``forward``)."""
    qmin, qmax = int(pos_q.min()), int(pos_q.max())
    kmin, kmax = int(pos_k.min()), int(pos_k.max())
    dead = False
    if cfg.causal:
        dead = dead or kmin > qmax
    if cfg.window is not None:
        p = (qmin - kmax) >= cfg.window
        if not cfg.causal:
            p = p and (kmin - qmax) >= cfg.window
        dead = dead or p
    if cfg.prefix_len is not None:
        dead = dead and kmin >= cfg.prefix_len
    return dead


# ---------------------------------------------------------------------------
# the per-rank forward and backward
# ---------------------------------------------------------------------------

class _RingTransfer:
    """One ring transfer in flight, as ``cfg.comm_chunks`` sub-chunk
    transfers along the sequence axis ``dim`` (``_chunked_ppermute``):
    ``wait()`` returns the whole tensor."""

    def __init__(self, x, cfg: StarTrailConfig, comm, perm, dim: int):
        n = cfg.comm_chunks
        if n > 1 and x.shape[dim] % n:
            raise ValueError(
                f"comm_chunks={n} must divide the permuted sequence "
                f"axis (got length {x.shape[dim]})")
        parts = x.split(x.shape[dim] // n, dim) if n > 1 else (x,)
        self.dim = dim
        self.handles = [comm.ppermute_start(part, cfg.axes, perm)
                        for part in parts]

    def wait(self):
        # the parts go with the handles once they are joined
        handles, self.handles = self.handles, None
        if len(handles) == 1:
            return handles[0].wait()
        return torch.cat([h.wait() for h in handles], self.dim)


def _ring_permute(x, cfg: StarTrailConfig, comm, perm, dim: int):
    """One synchronous ring transfer of ``x``, in ``cfg.comm_chunks``
    sub-chunks (``_RingTransfer``'s values and bytes)."""
    n = cfg.comm_chunks
    if n <= 1:
        return comm.ppermute(x, cfg.axes, perm)
    if x.shape[dim] % n:
        raise ValueError(
            f"comm_chunks={n} must divide the permuted sequence "
            f"axis (got length {x.shape[dim]})")
    return torch.cat([comm.ppermute(part.contiguous(), cfg.axes, perm)
                      for part in x.split(x.shape[dim] // n, dim)], dim)


def _to_device(pos_h, dev):
    """Host positions on ``dev`` without a host sync: a blocking copy
    from host memory synchronises the stream, so each ring step would wait
    for every kernel queued before it and the ring's copies could never run
    beside a block kernel. (CUDA stages a pageable source before the call
    returns, so the host tensor may go at once.)"""
    return pos_h.to(dev, non_blocking=True)


def _note(comm, *event) -> None:
    """Append ``event`` and the pass to the rank's issue log, where the
    communicator keeps one (``dist.comm``)."""
    log = getattr(comm, "issue_log", None)
    if log is not None:
        log.append(event + (comm.ledger.phase,))


@contextlib.contextmanager
def _ring_scope(name: str, comm):
    """The JAX ``jax.named_scope(name)`` of the ring: a
    ``torch.profiler`` range, noted in the issue log."""
    _note(comm, "scope", name)
    with _trace_annotation(name):
        yield


def _coords(cfg: StarTrailConfig, comm):
    """(c, r, p, topology, (g, j, t)) of this rank."""
    g_ax, r_ax, t_ax = cfg.axes
    c = comm.axis_size(t_ax)
    r = comm.axis_size(r_ax)
    if comm.axis_size(g_ax) != c:
        raise ValueError(
            f"sp_grp axis size {comm.axis_size(g_ax)} must equal sp_team "
            f"axis size {c} (both are the paper's C)")
    p = c * c * r
    tp = topo_lib.StarTrailTopology(sp_size=p, c=c)
    return c, r, p, tp, tuple(comm.axis_index(a) for a in cfg.axes)


def startrail_forward(q, k, v, cfg: StarTrailConfig, comm):
    """The per-rank forward: q (B, S, Hq, D); k, v (B, S, Hkv, D), S = N / P
    with the rank's tokens laid out by ``cfg.seq_scheme``. Returns
    ``(o, res)``: o (B, S, Hq, D) in q's dtype and the residuals
    ``res = (q_team, k0, v0, lse_glob)`` the backward needs."""
    c, r, p, tp, (gi, ji, ti) = _coords(cfg, comm)
    t_ax = cfg.axes[2]
    B, S, Hq, D = q.shape
    dev = q.device

    # 1. team gather
    q_team = comm.all_gather(q, t_ax, 1)
    k_team = comm.all_gather(k, t_ax, 1)
    v_team = comm.all_gather(v, t_ax, 1)

    # 2. initial K/V placement (paper Alg. 2)
    perm = tp.init_placement_permutation()
    k0 = comm.ppermute(k_team, cfg.axes, perm)
    v0 = comm.ppermute(v_team, cfg.axes, perm)

    # positions on the host (for the skip decision), once on the device;
    # every copy to the device is non-blocking (``_to_device``)
    own_team = gi * r + ji
    pos_q_h = team_positions(own_team, c, cfg.seq_len, p, cfg.seq_scheme)
    pos_q = _to_device(pos_q_h, dev)
    ring_perm = tp.ring_permutation()

    # 3. concentric-ring steps, each folding its block into the accumulator
    o_acc = torch.zeros((B, c * S, Hq, D), dtype=torch.float32, device=dev)
    lse_acc = torch.full((B, Hq, c * S), NEG_INF, dtype=torch.float32,
                         device=dev)
    k_cur, v_cur = k0, v0

    for s in range(r):
        kv_team = ((ji + s) % r) * c + ti
        pos_k_h = team_positions(kv_team, c, cfg.seq_len, p, cfg.seq_scheme)
        # pipelined: step s+1's K/V leave before step s's block kernel
        nxt = None
        if cfg.pipeline and s < r - 1:
            with _ring_scope("ring_permute_issue", comm):
                nxt = [_RingTransfer(t, cfg, comm, ring_perm, 1)
                       for t in (k_cur, v_cur)]
        if not (cfg.block_skip and fully_masked(cfg, pos_q_h, pos_k_h)):
            with _ring_scope("ring_block_compute", comm):
                _note(comm, "block")
                o_acc, lse_acc = kernels.block_fwd_merge(
                    q_team, k_cur, v_cur, o_acc, lse_acc, pos_q,
                    _to_device(pos_k_h, dev), causal=cfg.causal,
                    window=cfg.window, scale=cfg.scale,
                    prefix_len=cfg.prefix_len, impl=cfg.block_impl)
        if s < r - 1 and nxt is None:
            with _ring_scope("ring_permute_issue", comm):
                k_cur = _ring_permute(k_cur, cfg, comm, ring_perm, 1)
                v_cur = _ring_permute(v_cur, cfg, comm, ring_perm, 1)
        elif s < r - 1:
            # one at a time, as above: a trace's (``TraceComm``) live
            # storages stay those of the synchronous order
            k_cur = nxt[0].wait()
            v_cur = nxt[1].wait()

    # 4. lse-combine + reduce-scatter (paper: ReduceScatter_combine)
    m = comm.pmax(lse_acc, t_ax)
    dead = m <= NEG_INF / 2
    m_safe = torch.where(dead, 0.0, m)
    se = comm.psum(torch.exp(lse_acc - m_safe), t_ax)
    se_safe = torch.where(se == 0.0, 1.0, se)
    lse_glob = torch.where(dead, NEG_INF, m_safe + torch.log(se_safe))
    w = torch.exp(lse_acc - torch.where(dead, 0.0, lse_glob))
    w = torch.where(dead, 0.0, w)
    o_scaled = o_acc * w.transpose(1, 2)[..., None]
    o_local = comm.psum_scatter(o_scaled, t_ax, 1)
    return o_local.to(q.dtype), (q_team, k0, v0, lse_glob)


def startrail_backward(res, o, do, cfg: StarTrailConfig, comm):
    """The per-rank backward (paper: two loops; the Q pack circulates, the
    K/V gradients stay resident). ``res`` and ``o`` (in q's dtype) come
    from ``startrail_forward``; ``do`` is the gradient of o. Returns
    (dq, dk, dv) in f32 with the shapes of the rank's q, k, v."""
    q_team, k0, v0, lse_glob = res
    c, r, p, tp, (gi, ji, ti) = _coords(cfg, comm)
    t_ax = cfg.axes[2]
    B, CS, Hq, D = q_team.shape
    Hkv = k0.shape[2]
    dev = q_team.device

    do = do.contiguous()
    delta_local = torch.einsum("bshd,bshd->bhs", do.float(), o.float())
    do_team = comm.all_gather(do, t_ax, 1)
    delta_team = comm.all_gather(delta_local.contiguous(), t_ax, 2)

    # K/V (and their positions) stay resident on this rank
    kv_team_idx = ji * c + ti
    pos_k = team_positions(kv_team_idx, c, cfg.seq_len, p,
                           cfg.seq_scheme)
    pos_k_d = _to_device(pos_k, dev)
    ring_perm = tp.ring_permutation()

    pack = dict(q=q_team, do=do_team, delta=delta_team, lse=lse_glob)
    # the sequence axis each circulating tensor is chunked along
    seq_dim = dict(q=1, do=1, delta=2, lse=2)
    dq = torch.zeros((B, CS, Hq, D), dtype=torch.float32, device=dev)
    dk_acc = torch.zeros((B, CS, Hkv, D), dtype=torch.float32, device=dev)
    dv_acc = torch.zeros((B, CS, Hkv, D), dtype=torch.float32, device=dev)

    for s in range(r):
        # after s ring permutes this rank holds the pack of ring slot j + s
        team = gi * r + (ji + s) % r
        pos_q = team_positions(team, c, cfg.seq_len, p, cfg.seq_scheme)
        # pipelined: the next step's inputs leave before this step's block
        # kernel; dq, which the kernel makes, leaves after it
        nxt = None
        if cfg.pipeline and s < r - 1:
            with _ring_scope("ring_permute_issue", comm):
                nxt = {n: _RingTransfer(a, cfg, comm, ring_perm, seq_dim[n])
                       for n, a in pack.items()}
        if not (cfg.block_skip and fully_masked(cfg, pos_q, pos_k)):
            with _ring_scope("ring_block_compute", comm):
                _note(comm, "block")
                dq_c, dk_c, dv_c = kernels.block_bwd(
                    pack["q"], k0, v0, pack["do"], pack["lse"],
                    pack["delta"], _to_device(pos_q, dev), pos_k_d,
                    causal=cfg.causal, window=cfg.window, scale=cfg.scale,
                    prefix_len=cfg.prefix_len, impl=cfg.block_impl)
                dq = dq + dq_c
                dk_acc = dk_acc + dk_c
                dv_acc = dv_acc + dv_c
        # dq makes the full tour home; the inputs are not needed after
        # the last step
        with _ring_scope("ring_permute_issue", comm):
            dq = _ring_permute(dq, cfg, comm, ring_perm, 1)
            if s < r - 1 and nxt is None:
                pack = {n: _ring_permute(a, cfg, comm, ring_perm, seq_dim[n])
                        for n, a in pack.items()}
        if nxt is not None:
            pack = {n: t.wait() for n, t in nxt.items()}

    dq_local = comm.psum_scatter(dq, t_ax, 1)
    inv = tp.inverse_placement_permutation()
    dk_team = comm.ppermute(dk_acc, cfg.axes, inv)
    dv_team = comm.ppermute(dv_acc, cfg.axes, inv)
    dk_local = comm.psum_scatter(dk_team, t_ax, 1)
    dv_local = comm.psum_scatter(dv_team, t_ax, 1)
    return dq_local, dk_local, dv_local


class StarTrailAttention(torch.autograd.Function):
    """``startrail_forward`` with ``startrail_backward`` as its gradient
    (the JAX ``custom_vjp``). The residuals are kept only when an input
    needs a gradient, so the serving path (under ``torch.no_grad``, with
    frozen parameters) keeps none. The gradients come back in the input
    dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, cfg, comm):
        o, res = startrail_forward(q, k, v, cfg, comm)
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(*res, o)
            ctx.cfg, ctx.comm = cfg, comm
        return o

    @staticmethod
    def backward(ctx, do):
        # unpacked first: under recompute this reruns the forward, whose
        # collectives the ledger counts as forward ones
        q_team, k0, v0, lse_glob, o = ctx.saved_tensors
        with ctx.comm.ledger.backward():
            dq, dk, dv = startrail_backward((q_team, k0, v0, lse_glob), o,
                                            do, ctx.cfg, ctx.comm)
        return (dq.to(q_team.dtype), dk.to(k0.dtype), dv.to(v0.dtype),
                None, None)


def startrail_attention(q, k, v, cfg: StarTrailConfig, comm) -> torch.Tensor:
    """Exact full-sequence attention for sequence-sharded q, k, v, and
    differentiable: ``StarTrailAttention.apply``. Per rank: q (B, S, Hq, D);
    k, v (B, S, Hkv, D). Returns o (B, S, Hq, D) in q's dtype."""
    return StarTrailAttention.apply(q, k, v, cfg, comm)


# ---------------------------------------------------------------------------
# decode-time combine: per-shard partials -> full attention
# ---------------------------------------------------------------------------

def combine_decode_partials(o, lse, comm, axes):
    """Merge per-shard partial (o, lse) pairs over ``axes``. Shards whose
    lse is NEG_INF contribute exact zeros; a row dead on every shard comes
    out zero (the caller treats it as inactive)."""
    o, _ = combine_partials_with_lse(o, lse, comm, axes)
    return o


def combine_partials_with_lse(o, lse, comm, axes):
    """``combine_decode_partials`` that also returns the merged lse."""
    m = comm.pmax(lse, axes)
    dead = m <= NEG_INF / 2
    m_safe = torch.where(dead, 0.0, m)
    se = comm.psum(torch.exp(lse - m_safe), axes)
    se_safe = torch.where(se == 0.0, 1.0, se)
    w = torch.where(dead, 0.0, torch.exp(lse - m_safe) / se_safe)
    o = comm.psum(o * w.transpose(1, 2)[..., None], axes)
    lse_c = torch.where(dead, NEG_INF, m_safe + torch.log(se_safe))
    return o, lse_c


def decode_attention(q_new, k_cache, v_cache, pos_q, pos_k,
                     cfg: StarTrailConfig, comm):
    """Per-shard decode attention against this shard's contiguous cache
    slice, merged over the SP axes: q_new (B, M, Hq, D) replicated over SP;
    k_cache / v_cache (B, S_local, Hkv, D); pos_q (M,) or (B, M), pos_k
    (S_local,) or (B, S_local). Returns (B, M, Hq, D) in q's dtype.

    Validity is positional: callers push the positions of unfilled slots
    past the query (``cache_len + 1``) so the causal mask removes them.
    Batched positions run kernel B5 under ``block_impl='cuda'``.
    """
    o, lse = kernels.decode(q_new, k_cache, v_cache, pos_q, pos_k,
                            causal=cfg.causal, window=cfg.window,
                            scale=cfg.scale, impl=cfg.block_impl)
    return combine_decode_partials(o, lse, comm,
                                   tuple(cfg.axes)).to(q_new.dtype)
