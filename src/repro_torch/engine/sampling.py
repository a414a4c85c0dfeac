"""Vocab-parallel greedy sampling without gathering the full logits (the
port's counterpart of ``repro.engine.sampling``, lines 57-99).

The vocabulary is split over the SP ranks; each rank scores its slice of
the LM head and the global argmax is a lexicographic combine: ``pmax`` of
the values, ``pmin`` of the winning rank, ``psum`` of the winner's token
id. Ties break toward the lowest rank and, within a rank, toward the lowest
local index (``torch.argmax`` returns the first maximum), i.e. toward the
smallest global token id. Temperature / top-k / top-p sampling is not
ported yet (ROADMAP.md §A): the JAX engine keys its gumbel noise with
threefry, which PyTorch does not reproduce.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks

NEG = -1e30


def shard_logits(rt, head, x, cfg: ModelConfig):
    """This rank's vocab-slice logits for the newest position.

    x: (B, 1, D) replicated over SP. Returns (logits (B, V_local) float32
    with padded vocab rows at NEG, lo = first global token id of the slice).
    """
    table, lo = blocks.vocab_slice(rt, rt.dense(head.table))
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
