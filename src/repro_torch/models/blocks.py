"""Transformer blocks (the port's counterpart of ``repro.models.blocks``).

``<block>_specs(cfg)`` declares parameters in the JAX package's einsum
layouts (``wq (D, Hq, hd)``, ``wo (Hq, hd, D)``, ...); ``<block>(rt, p, x,
...)`` applies the submodule ``p`` holding them. Norms and residuals in
float32; matmuls in the parameter dtype. Collectives go through the
``Runtime``'s communicator, so the same code serves one rank and P ranks.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.spec import PSpec


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_specs(d: int):
    return {"scale": PSpec((d,), ("embed_nosplit",), init="ones")}


def rmsnorm(p, x, eps: float = 1e-5):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p.scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float = 10000.0):
    """x: (B, S, H, D); positions: (S,) global token positions, or (B, S)
    per-sequence positions (continuous-batching decode)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions.float()[..., :, None] * freqs          # (..., S, half)
    if ang.dim() == 2:
        ang = ang[None]                                     # (1|B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention block (StarTrail inside)
# ---------------------------------------------------------------------------

def attention_specs(cfg: ModelConfig):
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    return {
        "wq": PSpec((d, hq, hd), ("embed", "heads", "head_dim")),
        "wk": PSpec((d, hkv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": PSpec((d, hkv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": PSpec((hq, hd, d), ("heads", "head_dim", "embed_out")),
        "norm": rmsnorm_specs(d),
    }


def qkv(rt, p, h):
    """Projections of the normed input h (B, S, D) -> q, k, v (B, S, H, hd)."""
    q = torch.einsum("bsd,dhk->bshk", h, rt.dense(p.wq))
    k = torch.einsum("bsd,dhk->bshk", h, rt.dense(p.wk))
    v = torch.einsum("bsd,dhk->bshk", h, rt.dense(p.wv))
    return q, k, v


def attention_block(rt, p, x, cfg: ModelConfig, *, causal: bool = True,
                    window: Optional[int] = None,
                    prefix_len: Optional[int] = None,
                    return_kv: bool = False):
    """Pre-norm attention with residual. x: (B, S_local, D)."""
    h = rmsnorm(p.norm, x, cfg.norm_eps)
    q, k, v = qkv(rt, p, h)
    pos = rt.positions(x.shape[1])
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    o = rt.attention(q, k, v, causal=causal, window=window,
                     prefix_len=prefix_len)
    out = x + torch.einsum("bshk,hkd->bsd", o, rt.dense(p.wo))
    if return_kv:
        return out, (k, v)
    return out


# ---------------------------------------------------------------------------
# MLP: SwiGLU; tokens all-gathered over the SP axes, reduce-scattered back
# (the JAX package's 'default' rules; identities at P = 1)
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "w1": PSpec((d, f), ("embed", "ffn")),
        "w3": PSpec((d, f), ("embed", "ffn")),
        "w2": PSpec((f, d), ("ffn", "embed_out")),
        "norm": rmsnorm_specs(d),
    }


def mlp_block(rt, p, x, cfg: ModelConfig):
    """Tensor-parallel SwiGLU: rank p multiplies its slice of the ffn dim
    (the port stores the weights whole), the reduce-scatter sums them."""
    h = rmsnorm(p.norm, x, cfg.norm_eps)
    hg = rt.all_gather_model(h, axis=1)
    w1, w3, w2 = rt.dense(p.w1), rt.dense(p.w3), rt.dense(p.w2)
    f_local = w1.shape[1] // rt.sp_size()
    lo = rt.sp_rank() * f_local
    u = torch.einsum("bsd,df->bsf", hg, w1[:, lo:lo + f_local])
    g = torch.einsum("bsd,df->bsf", hg, w3[:, lo:lo + f_local])
    a = F.silu(u.float()).to(u.dtype) * g
    o = torch.einsum("bsf,fd->bsd", a, w2[lo:lo + f_local])
    return x + rt.psum_scatter_model(o, axis=1)


# ---------------------------------------------------------------------------
# vocab-parallel embedding + logits/loss (Megatron-style over the SP axes)
# ---------------------------------------------------------------------------

def padded_vocab(cfg: ModelConfig, multiple: int = 32) -> int:
    """Megatron-style vocab padding so the table splits evenly."""
    v = cfg.vocab_size
    return ((v + multiple - 1) // multiple) * multiple


def embedding_specs(cfg: ModelConfig):
    # d^-0.5 keeps initial logits O(1) (the table doubles as the LM head)
    return {"table": PSpec((padded_vocab(cfg), cfg.d_model),
                           ("vocab", "embed"), scale=cfg.d_model ** -0.5)}


def vocab_slice(rt, table):
    """This rank's rows of a whole (V, D) table -> (rows, first token id).
    The port stores tables whole; rank p owns rows [p*V/P, (p+1)*V/P)."""
    v_local = table.shape[0] // rt.sp_size()
    lo = rt.sp_rank() * v_local
    return table[lo:lo + v_local], lo


def _vocab_shard_lookup(rt, table, ids):
    """Look up ids in this rank's vocab slice (zeros outside)."""
    rows, lo = vocab_slice(rt, table)
    ids = ids - lo
    in_range = (ids >= 0) & (ids < rows.shape[0])
    ids = ids.clamp(0, rows.shape[0] - 1)
    return rows[ids] * in_range[..., None].to(rows.dtype)


def embed(rt, p, tokens, cfg: ModelConfig, *,
          tokens_replicated: bool = False):
    """tokens: (B, S_local) int -> (B, S_local, D), vocab-parallel.

    Sequence-sharded tokens are all-gathered, looked up in this rank's vocab
    slice, and a reduce-scatter sums the slices and returns each rank its
    own positions; replicated (decode) tokens need only the sum.
    """
    table = rt.dense(p.table)
    if tokens_replicated:
        return rt.psum_model(_vocab_shard_lookup(rt, table, tokens))
    tokens_all = rt.all_gather_model(tokens, axis=1)
    return rt.psum_scatter_model(
        _vocab_shard_lookup(rt, table, tokens_all), axis=1)


def lm_head_logits_and_loss(rt, p, x, labels, cfg: ModelConfig, mask=None):
    """Vocab-parallel cross-entropy (the JAX spmd form). x: (B, S_local, D);
    labels (B, S_local); mask (B, S_local) or None.

    Sequence and vocab are split over the same SP axes, so the loss runs
    over the P gathered shards' activations in turn: this rank computes its
    vocab slice's logits for one shard, and a psum combines the logsumexp
    and gold terms. Full logits are never held (B x S_local x V/P at a
    time). Returns the mean loss over the (masked) tokens.
    """
    table, lo = vocab_slice(rt, rt.dense(p.table))
    v_local = table.shape[0]
    tf32 = table.float()
    x_all = rt.all_gather_sp_stack(x)                 # (P, B, S_l, D)
    lab_all = rt.all_gather_sp_stack(labels)          # (P, B, S_l)
    if mask is not None:
        mask_all = rt.all_gather_sp_stack(mask)
    else:
        mask_all = torch.ones(lab_all.shape, dtype=torch.float32,
                              device=x.device)
    row_valid = (lo + torch.arange(v_local, device=x.device)) \
        < cfg.vocab_size
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    denom = torch.zeros((), dtype=torch.float32, device=x.device)
    for xi, li, mi in zip(x_all, lab_all, mask_all):
        logits = torch.einsum("bsd,vd->bsv", xi.float(), tf32)
        logits = torch.where(row_valid, logits, -1e30)  # padded vocab rows
        # the logsumexp shift is gradient-invariant: detach it before the
        # pmax, as the JAX stop_gradient does
        m = rt.comm.pmax(logits.amax(dim=-1).detach(), rt.sp_axes)
        se = rt.comm.psum(torch.exp(logits - m[..., None]).sum(dim=-1),
                          rt.sp_axes)
        logz = m + torch.log(se)
        ids = li.long() - lo
        in_range = (ids >= 0) & (ids < v_local)
        ids = ids.clamp(0, v_local - 1)
        gold_loc = logits.gather(-1, ids[..., None])[..., 0]
        gold = rt.comm.psum(gold_loc * in_range.float(), rt.sp_axes)
        losses = (logz - gold) * mi
        total = total + losses.sum()
        denom = denom + mi.sum()
    # total/denom are identical on every SP rank; reduce over batch axes only
    return rt.psum_batch(total) / rt.psum_batch(denom)
