"""Serving: prefill and paged decode steps (the port's counterpart of
``repro.serve.step`` lines 43-114, 230-299 and 377-458).

decode: one new token per sequence against the paged, SP-sharded KV pool.
  Each rank writes the token into its page (``paged_cache.write_token``),
  scores its own pages (``dispatch.paged_decode``: kernel B4 on 'cuda'),
  and the partial (o, lse) pairs merge across ranks
  (``startrail.combine_decode_partials``). Vocab-parallel greedy sampling.

prefill: the full forward pass (StarTrail attention: kernel B2 on 'cuda';
  B1 under the local attention of ``Runtime``) returning every layer's K/V for the paged insert, and the hidden
  state of position ``prompt_len - 1``.

Only dense, all-attention stacks are ported; the per-rank functions take
the ``Runtime`` (communicator + attention config) and the ``Model``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import startrail as st
from repro_torch.engine import paged_cache, sampling
from repro_torch.kernels import dispatch as kernels
from repro_torch.models import blocks


def _attn_decode(rt, p, x, cache, cfg: ModelConfig, cache_len,
                 paged: paged_cache.PagedTables):
    """x: (B, 1, D) replicated over SP; cache: {'k','v'} this layer's pool
    slices (pages_loc, page_size, Hkv, hd), updated in place; cache_len:
    (B,) int32 device tensor, the new token's position."""
    h = blocks.rmsnorm(p.norm, x, cfg.norm_eps)
    q, k_new, v_new = blocks.qkv(rt, p, h)
    pos_new = cache_len[:, None]                                  # (B, 1)
    q = blocks.rope(q, pos_new, cfg.rope_theta)
    k_new = blocks.rope(k_new, pos_new, cfg.rope_theta)
    paged_cache.write_token(rt, cache, k_new, v_new, paged)
    o_p, lse_p = kernels.paged_decode(
        q.contiguous(), cache["k"], cache["v"], paged.local_table(
            rt.sp_rank()), cache_len, rt.sp_rank(), sp=rt.sp_size(),
        page_size=paged.page_size, window=cfg.window, impl=rt.kernel_impl)
    o = st.combine_decode_partials(o_p, lse_p, rt.comm,
                                   rt.sp_axes).to(x.dtype)
    return x + torch.einsum("bshk,hkd->bsd", o, rt.dense(p.wo))


def lm_decode_step(rt, model, pools, tokens, cfg: ModelConfig, cache_len,
                   paged: paged_cache.PagedTables):
    """tokens: (B, 1) int64 (replicated across SP); cache_len: (B,) int32.
    pools: {'k','v'} (L, pages_loc, ps, Hkv, hd), updated in place.
    Returns the greedy next tokens (B, 1) int32."""
    x = blocks.embed(rt, model.embed, tokens, cfg, tokens_replicated=True)
    for i, layer in enumerate(model.layers):
        x = _attn_decode(rt, layer.mixer, x,
                         {"k": pools["k"][i], "v": pools["v"][i]}, cfg,
                         cache_len, paged)
        x = blocks.mlp_block(rt, layer.mlp, x, cfg)
    x = blocks.rmsnorm(model.final_norm, x, cfg.norm_eps)
    return sampling.greedy(rt, model.head, x, cfg)


def lm_prefill(rt, model, tokens, cfg: ModelConfig,
               prompt_len: Optional[torch.Tensor] = None,
               return_hidden: bool = False):
    """Full forward pass over the prompt, collecting the serving cache.

    tokens: (B, S_local) int64, this rank's contiguous slice of the prompt
      of ``rt.st_cfg.seq_len`` tokens (right-padded, if at all, past the
      real length). Returns
      ``(next_token or hidden, (k_stack, v_stack))`` with K/V stacks
      (L, B, S_local, Hkv, hd), post-RoPE.
    prompt_len: optional (B,) int32 real prompt lengths; the next-token
      hidden state is then taken at ``prompt_len - 1`` instead of the last
      slot. Causal attention makes right-padding harmless before it.
    return_hidden: return the (B, 1, D) pre-head hidden state (replicated
      across SP) instead of a greedily sampled token.
    """
    x = blocks.embed(rt, model.embed, tokens, cfg)
    ks, vs = [], []
    for layer in model.layers:
        x, (k, v) = blocks.attention_block(
            rt, layer.mixer, x, cfg, causal=True, window=cfg.window,
            return_kv=True)
        ks.append(k)
        vs.append(v)
        x = blocks.mlp_block(rt, layer.mlp, x, cfg)
    x = blocks.rmsnorm(model.final_norm, x, cfg.norm_eps)
    if prompt_len is None:
        # the last position: the last rank's final slot (contiguous layout)
        last = x[:, -1:, :]
        if rt.sp_rank() != rt.sp_size() - 1:
            last = torch.zeros_like(last)
        last = rt.psum_model(last)
    else:
        # exactly one (rank, slot) holds position prompt_len - 1: a one-hot
        # contraction plus psum broadcasts it everywhere
        target = prompt_len.to(torch.int32) - 1                    # (B,)
        pos = rt.positions_contig(x.shape[1])                      # (S_loc,)
        onehot = (pos[None] == target[:, None]).float()
        last = torch.einsum("bs,bsd->bd", onehot, x.float())[:, None]
        last = rt.psum_model(last).to(x.dtype)
    cache = (torch.stack(ks), torch.stack(vs))
    if return_hidden:
        return last, cache
    return sampling.greedy(rt, model.head, last, cfg), cache
