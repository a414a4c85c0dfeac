"""Plain PyTorch reference (oracle) for block flash attention.

Port of ``repro.kernels.ref`` (lines 32-212). These functions are the
semantic ground truth for the CUDA kernels in ``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu`` and ``csrc/paged_decode.cu`` and run on any device.

Conventions (the JAX package's layouts, kept at every public function):
  q        : (B, Sq, Hq, D)
  k, v     : (B, Sk, Hkv, D), Hq = G * Hkv (GQA; G = 1 is MHA)
  pos_q/k  : (Sq,) / (Sk,) int32 global token positions, or (B, Sq) /
             (B, Sk) per-sequence positions; masks come from positions, so
             zigzag and contiguous layouts are both exact
  o        : (B, Sq, Hq, D) float32
  lse      : (B, Hq, Sq)   float32 log-sum-exp of the masked scores

All reductions are float32 whatever the input dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.combine import NEG_INF, combine_pair


def make_mask(pos_q, pos_k, *, causal: bool, window: Optional[int] = None,
              prefix_len: Optional[int] = None) -> Optional[torch.Tensor]:
    """(Sq, Sk) bool mask, or (B, Sq, Sk) when either position tensor has a
    leading batch dim. None means fully visible.

    prefix_len: prefix-LM: keys with pos < prefix_len are visible to every
    query (bidirectional prefix), the rest follows the causal/window rule.
    """
    if not causal and window is None:
        return None
    pq = pos_q[..., :, None]
    pk = pos_k[..., None, :]
    mask = None
    if causal:
        cm = pk <= pq
        if prefix_len is not None:
            cm = cm | (pk < prefix_len)
        mask = cm
    if window is not None:
        wm = (pq - pk) < window
        if not causal:
            wm = wm & ((pk - pq) < window)
        if prefix_len is not None:
            wm = wm | (pk < prefix_len)
        mask = wm if mask is None else (mask & wm)
    return mask


def block_attention(q, k, v, pos_q, pos_k, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None,
                    prefix_len: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked attention of a (Q block x K/V block) pair -> (o, lse).

    o is normalised within the block; (o, lse) pairs over disjoint key
    blocks merge exactly via ``core.combine.combine_pair``. Rows with no
    visible key give o = 0 and lse = NEG_INF exactly.
    """
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if Hq % Hkv != 0:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)

    qf = q.float().reshape(B, Sq, Hkv, G, D)
    kf = k.float()
    vf = v.float()

    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale  # (B,Hkv,G,Sq,Sk)
    mask = make_mask(pos_q, pos_k, causal=causal, window=window,
                     prefix_len=prefix_len)
    if mask is not None:
        mask = mask[None, None, None] if mask.dim() == 2 \
            else mask[:, None, None]
        s = torch.where(mask, s, NEG_INF)

    m = s.amax(dim=-1)                                     # (B,Hkv,G,Sq)
    dead = m <= NEG_INF / 2
    m_safe = torch.where(dead, 0.0, m)
    p = torch.exp(s - m_safe[..., None])
    if mask is not None:
        p = p * mask
    l = p.sum(dim=-1)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf) \
        / l_safe.permute(0, 3, 1, 2)[..., None]
    lse = torch.where(dead, NEG_INF, m_safe + torch.log(l_safe))
    return o.reshape(B, Sq, Hq, D), lse.reshape(B, Hq, Sq)


def block_attention_merge(q, k, v, o_acc, lse_acc, pos_q, pos_k, *,
                          causal: bool = True, window: Optional[int] = None,
                          scale: Optional[float] = None,
                          prefix_len: Optional[int] = None):
    """One ring step's block attention merged into a running accumulator:
    ``block_attention`` then ``combine_pair`` (the oracle of the fused-merge
    kernel)."""
    o_s, lse_s = block_attention(q, k, v, pos_q, pos_k, causal=causal,
                                 window=window, scale=scale,
                                 prefix_len=prefix_len)
    return combine_pair(o_acc, lse_acc, o_s, lse_s)


def block_attention_bwd(q, k, v, do, lse, delta, pos_q, pos_k, *,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None,
                        prefix_len: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash-attention backward for one (Q block x K/V block) pair.

    Uses the *global* lse (over the full key set) and
    delta_i = sum_d do_i * o_final_i, so each pair's contribution is the
    exact partial derivative of full softmax attention:

        p_ij = exp(s_ij - lse_i)            (true attention probabilities)
        dv_j = sum_i p_ij do_i
        ds_ij = p_ij (do_i . v_j - delta_i)
        dq_i = scale * sum_j ds_ij k_j ;  dk_j = scale * sum_i ds_ij q_i

    Shapes: do (B,Sq,Hq,D); lse, delta (B,Hq,Sq). Returns (dq, dk, dv) in
    float32 with the shapes of q, k, v. Rows with lse = NEG_INF (no visible
    key) give p = 0: dq = 0 there and nothing into dk, dv.
    """
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)

    qf = q.float().reshape(B, Sq, Hkv, G, D)
    kf = k.float()
    vf = v.float()
    dof = do.float().reshape(B, Sq, Hkv, G, D)
    lsef = lse.float().reshape(B, Hkv, G, Sq)
    deltaf = delta.float().reshape(B, Hkv, G, Sq)

    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    mask = make_mask(pos_q, pos_k, causal=causal, window=window,
                     prefix_len=prefix_len)
    if mask is not None:
        # mask BEFORE the exp: masked raw scores can exceed lse (which only
        # covers unmasked entries), and exp would overflow to inf -> NaN
        mask = mask[None, None, None] if mask.dim() == 2 \
            else mask[:, None, None]
        s = torch.where(mask, s, NEG_INF)
    dead = lsef <= NEG_INF / 2
    lse_safe = torch.where(dead, 0.0, lsef)
    p = torch.exp(s - lse_safe[..., None])
    p = torch.where(dead[..., None], 0.0, p)

    # (B, Hkv, G, Sq, Sk)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = p * (dp - deltaf[..., None]) * scale

    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(B, Sq, Hq, D)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return dq, dk, dv


def mha_reference(q, k, v, *, positions=None, causal: bool = True,
                  window: Optional[int] = None, scale: Optional[float] = None,
                  prefix_len: Optional[int] = None) -> torch.Tensor:
    """Plain full (non-distributed) attention, the end-to-end oracle."""
    S = q.shape[1]
    pos = positions if positions is not None else torch.arange(
        S, dtype=torch.int32, device=q.device)
    o, _ = block_attention(q, k, v, pos, pos, causal=causal, window=window,
                           scale=scale, prefix_len=prefix_len)
    return o.to(q.dtype)
