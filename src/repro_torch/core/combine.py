"""Numerically-stable combination of partial softmax-attention results.

A partial result is a pair (o, lse) where

    o   = softmax(s_block) @ v_block          (normalised within the block)
    lse = logsumexp(s_block, axis=keys)

Two partials over disjoint key sets merge exactly:

    m      = max(lse1, lse2)
    w_i    = exp(lse_i - m)
    o      = (w1 * o1 + w2 * o2) / (w1 + w2)
    lse    = m + log(w1 + w2)

Fully-masked blocks carry lse = NEG_INF and weight 0. All math in float32.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # finite stand-in for -inf: keeps the combines NaN-free


def combine_pair(o1, lse1, o2, lse2):
    """Merge two partial attention results.

    Shapes: o (..., S, H, D); lse (..., H, S). Returns (o, lse) in f32.
    """
    o1, o2 = o1.float(), o2.float()
    lse1, lse2 = lse1.float(), lse2.float()
    m = torch.maximum(lse1, lse2)
    # both NEG_INF: the row saw no keys at all; emit zeros
    both_dead = m <= NEG_INF / 2
    m_safe = torch.where(both_dead, 0.0, m)
    w1 = torch.exp(lse1 - m_safe)
    w2 = torch.exp(lse2 - m_safe)
    denom = w1 + w2
    denom_safe = torch.where(denom == 0.0, 1.0, denom)
    o = (lse_to_o_layout(w1) * o1 + lse_to_o_layout(w2) * o2) \
        / lse_to_o_layout(denom_safe)
    lse = torch.where(both_dead, NEG_INF, m_safe + torch.log(denom_safe))
    return o, lse


def lse_to_o_layout(x):
    """(..., H, S) -> (..., S, H, 1) to broadcast against o."""
    return x.transpose(-1, -2)[..., None]
