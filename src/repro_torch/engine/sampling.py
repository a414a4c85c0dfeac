"""Vocab-parallel sampling: greedy, temperature, top-k and top-p without
gathering the full logits (the port's counterpart of
``repro.engine.sampling``).

The vocabulary is split over the SP ranks; each rank scores its slice of
the LM head, and every primitive works on the local (B, V_local) logits
plus O(1)-sized collectives:

  * **greedy** — the global argmax is a lexicographic combine: ``pmax`` of
    the values, ``pmin`` of the winning rank, ``psum`` of the winner's token
    id. Ties break toward the lowest rank and, within a rank, toward the
    lowest local index (``torch.argmax`` returns the first maximum), i.e.
    toward the smallest global token id.
  * **temperature** — local scaling; sampling is gumbel-max
    (``argmax(logits / T + gumbel)`` is an exact categorical sample), and
    the argmax combines over ranks like greedy's.
  * **top-k** — each rank contributes its local top ``max_top_k`` values;
    the k-th largest of the gathered ``P * max_top_k`` is the global
    threshold, so the effective k is capped at ``max_top_k * P``.
  * **top-p** — a global softmax through ``pmax``/``psum``, then a
    fixed-iteration bisection on the probability threshold with the
    monotone mass ``psum(sum(probs[probs >= t]))``: the smallest set of
    most probable tokens whose mass reaches p, ties at the threshold kept.

Padded vocab rows (``lo + i >= vocab_size``) sit at ``NEG``: they never
pass top-k and get no noise.

**The noise.** JAX keys its gumbel noise with threefry on (request seed,
token position, SP rank). The port's is a pure function of the same
(seed, position, rank) and the local vocab index, so a request's tokens do
not depend on its batch, its slot or how its prompt was chunked:
``seed_key`` and ``fold_in`` mix the integers on the host (splitmix64), and
``gumbel`` seeds one ``torch.Generator`` per sampled row on the logits'
device with the result. The global RNG state is never used. The streams
are not threefry's (and differ between a CPU and a CUDA generator), so
tests that compare with JAX pass JAX's noise in through ``sample(noise=)``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks

NEG = -1e30
MAX_TOP_K = 64       # top-k candidates gathered per rank
NUCLEUS_ITERS = 30   # bisection steps for the top-p threshold
_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def seed_key(seed: int) -> int:
    """A request's base key (the JAX engine's ``PRNGKey(seed)``)."""
    return _splitmix64(seed & _M64)


def fold_in(key: int, data: int) -> int:
    """A new 64-bit key, a pure function of ``key`` and ``data`` (the key
    is mixed before the data goes in, so folds do not commute)."""
    return _splitmix64(_splitmix64(key) ^ (data & _M64))


def gumbel(keys: Sequence[Optional[int]], rank: int, v_local: int,
           device) -> torch.Tensor:
    """(B, V_local) float32 gumbel noise of this rank's vocab slice: row b
    drawn from a generator seeded with ``fold_in(keys[b], rank)``; rows
    whose key is None draw nothing (their noise is a constant)."""
    u = torch.full((len(keys), v_local), 0.5, device=device)
    for b, key in enumerate(keys):
        if key is not None:
            g = torch.Generator(device=device)
            g.manual_seed(fold_in(key, rank))
            torch.rand(v_local, generator=g, device=device, out=u[b])
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp_min_(tiny)))


def shard_logits(rt, head, x, cfg: ModelConfig):
    """This rank's vocab-slice logits for the newest position.

    x: (B, 1, D) replicated over SP. Returns (logits (B, V_local) float32
    with padded vocab rows at NEG, lo = first global token id of the slice).
    """
    table = rt.dense(head.table, blocks.TABLE_AXES)
    lo = blocks.vocab_start(rt, table)
    logits = torch.einsum("bsd,vd->bsv", x.float(), table.float())[:, 0]
    ids = lo + torch.arange(table.shape[0], device=logits.device)
    return torch.where(ids < cfg.vocab_size, logits, NEG), lo


def lowest_shard_argmax(rt, vals, lo: int):
    """Global argmax of rank-sliced (B, V_local) values -> (B,) int32 ids."""
    loc_max = vals.amax(dim=-1)
    loc_arg = vals.argmax(dim=-1).to(torch.int32)
    if rt.sp_size() == 1:
        return loc_arg
    comm, axes, rank = rt.comm, rt.sp_axes, rt.sp_rank()
    g_max = comm.pmax(loc_max, axes)
    win = loc_max >= g_max
    win_rank = comm.pmin(torch.where(
        win, torch.full_like(loc_arg, rank),
        torch.full_like(loc_arg, 2 ** 30)), axes)
    mine = win & (win_rank == rank)
    return comm.psum(torch.where(mine, loc_arg + lo,
                                 torch.zeros_like(loc_arg)), axes)


def greedy(rt, head, x, cfg: ModelConfig):
    """Greedy next token, vocab-parallel. x: (B, 1, D) -> (B, 1) int32."""
    logits, lo = shard_logits(rt, head, x, cfg)
    return lowest_shard_argmax(rt, logits, lo)[:, None]


def sample(rt, head, x, cfg: ModelConfig, *, temperature, top_k, top_p,
           keys: Optional[Sequence[Optional[int]]] = None,
           noise: Optional[torch.Tensor] = None,
           max_top_k: int = MAX_TOP_K):
    """Sample next tokens with per-row parameters: the vocab-wide argmax
    of each row of ``scores``. Returns (B, 1) int32."""
    s, lo = scores(rt, head, x, cfg, temperature=temperature, top_k=top_k,
                   top_p=top_p, keys=keys, noise=noise, max_top_k=max_top_k)
    return lowest_shard_argmax(rt, s, lo)[:, None]


def scores(rt, head, x, cfg: ModelConfig, *, temperature, top_k, top_p,
           keys: Optional[Sequence[Optional[int]]] = None,
           noise: Optional[torch.Tensor] = None,
           max_top_k: int = MAX_TOP_K):
    """This rank's (B, V_local) scores whose vocab-wide argmax is each
    row's sampled token, and the slice's first vocab id: a greedy row's
    logits; a sampled row's top-k/top-p survivors' logits / T plus its
    gumbel noise (NEG elsewhere).

    temperature: (B,) float32 tensor; rows with temperature <= 0 decode
      greedily.
    top_k: (B,) int tensor; 0 disables, effective values are capped at
      ``max_top_k * P``.
    top_p: (B,) float32 tensor; 1.0 disables.
    keys: B host keys already folded with the token position (``fold_in``;
      None for a row that draws no noise); the rank is folded in here.
    noise: a (B, V_local) tensor used in place of the draw (tests).
    max_top_k: candidates gathered per rank (tests raise it so that no
      rank's cap binds).
    """
    logits, lo = shard_logits(rt, head, x, cfg)
    B, v_local = logits.shape
    comm, axes = rt.comm, rt.sp_axes

    z = logits / temperature.clamp_min(1e-6)[:, None]

    # ---- top-k: global threshold from each rank's local top max_top_k ----
    kk = min(max_top_k, v_local)
    loc_top = torch.topk(z, kk, dim=-1).values                  # (B, kk)
    all_top = rt.all_gather_sp_stack(loc_top)                   # (P, B, kk)
    all_top = all_top.movedim(0, 1).reshape(B, -1)              # (B, P*kk)
    all_top = all_top.sort(dim=-1, descending=True).values
    idx = (top_k.long() - 1).clamp(0, all_top.shape[-1] - 1)
    thr_k = all_top.gather(-1, idx[:, None])
    z = torch.where((top_k[:, None] > 0) & (z < thr_k), NEG, z)

    # ---- global softmax over the surviving tokens ----
    m = comm.pmax(z.amax(dim=-1), axes)                         # (B,)
    ez = torch.exp(z - m[:, None])
    se = comm.psum(ez.sum(dim=-1), axes)                        # (B,)
    probs = ez / se[:, None]

    # ---- top-p: bisect the largest threshold with mass(t) >= p ----
    lo_t = torch.zeros_like(top_p)
    hi_t = torch.ones_like(top_p)
    for _ in range(NUCLEUS_ITERS):
        mid = 0.5 * (lo_t + hi_t)
        mass = comm.psum(torch.where(probs >= mid[:, None], probs, 0.0)
                         .sum(dim=-1), axes)
        ge = mass >= top_p
        lo_t = torch.where(ge, mid, lo_t)
        hi_t = torch.where(ge, hi_t, mid)
    z = torch.where((top_p[:, None] < 1.0) & (probs < lo_t[:, None]), NEG, z)

    # ---- gumbel-max: argmax(z + g) is an exact categorical sample ----
    g = noise if noise is not None else gumbel(keys, rt.sp_rank(), v_local,
                                               logits.device)
    pert = torch.where(z <= NEG / 2, NEG, z + g)
    return torch.where((temperature <= 0.0)[:, None], logits, pert), lo
