"""Serving: prefill and decode steps (the port's counterpart of
``repro.serve.step`` lines 43-114, 230-299, 336-372, 377-458 and 461-557).

decode: one new token per sequence against the SP-sharded KV cache.
  * paged (the engine): each rank writes the token into its page
    (``paged_cache.write_token``), scores its own pages
    (``dispatch.paged_decode``: kernel B4 on 'cuda'), and the partial
    (o, lse) pairs merge across ranks (``startrail.combine_decode_partials``);
  * contiguous (the static-batch path, ``build_decode_step``): the token is
    written at ``cache_len`` (``kv_cache.write_token``), unfilled slots are
    pushed past the query, and ``startrail.decode_attention`` scores the
    cache with per-row positions (kernel B5 on 'cuda').
  Vocab-parallel greedy or sampled (temperature, top-k, top-p) tokens.

prefill: the full forward pass (StarTrail attention: kernel B2 on 'cuda';
  B1 under the local attention of ``Runtime``) returning every layer's K/V
  for the paged insert, and the hidden state of position
  ``prompt_len - 1``. ``lm_prefill_paged`` forwards only a prompt *suffix*
  (a prefix-cache hit or a later chunk), reading the cached prefix from
  the page pool (kernel B6) and writing the suffix K/V into its pages.

Only dense, all-attention stacks are ported; the per-rank functions take
the ``Runtime`` (communicator + attention config) and the ``Model``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.core import startrail as st
from repro_torch.core.combine import combine_pair
from repro_torch.engine import paged_cache
from repro_torch.engine import sampling as sampling_lib
from repro_torch.kernels import dispatch as kernels
from repro_torch.models import blocks
from repro_torch.serve import kv_cache


def _attn_decode(rt, p, x, cache, cfg: ModelConfig, cache_len,
                 paged: Optional[paged_cache.PagedTables]):
    """x: (B, 1, D) replicated over SP; cache_len: (B,) int32 device
    tensor, the new token's position. cache: {'k','v'} this layer's pool
    slices (pages_loc, page_size, Hkv, hd) when ``paged`` is given, else its
    contiguous cache slices (B, S_local, Hkv, hd); updated in place."""
    h = blocks.rmsnorm(p.norm, x, cfg.norm_eps)
    q, k_new, v_new = blocks.qkv(rt, p, h)
    pos_new = cache_len[:, None]                                  # (B, 1)
    q = blocks.rope(q, pos_new, cfg.rope_theta)
    k_new = blocks.rope(k_new, pos_new, cfg.rope_theta)
    if paged is not None:
        paged_cache.write_token(rt, cache, k_new, v_new, paged)
        o_p, lse_p = kernels.paged_decode(
            q.contiguous(), cache["k"], cache["v"], paged.local_table(
                rt.sp_rank()), cache_len, rt.sp_rank(), sp=rt.sp_size(),
            page_size=paged.page_size, window=cfg.window,
            impl=rt.kernel_impl)
        o = st.combine_decode_partials(o_p, lse_p, rt.comm,
                                       rt.sp_axes).to(x.dtype)
    else:
        kv_cache.write_token(rt, cache, k_new, v_new, cache_len)
        pos_k = rt.positions_contig(cache["k"].shape[1])
        # hide unfilled slots by pushing their positions past the query
        pos_k = torch.where(pos_k[None] <= cache_len[:, None], pos_k[None],
                            (cache_len + 1)[:, None])
        cfg_st = dataclasses.replace(rt.st_cfg, causal=True,
                                     window=cfg.window, prefix_len=None)
        o = st.decode_attention(q.contiguous(), cache["k"], cache["v"],
                                pos_new, pos_k, cfg_st, rt.comm)
    return x + torch.einsum("bshk,hkd->bsd", o, rt.dense(p.wo))


def lm_decode_step(rt, model, cache, tokens, cfg: ModelConfig, cache_len,
                   paged: Optional[paged_cache.PagedTables] = None,
                   return_hidden: bool = False, sampling=None):
    """tokens: (B, 1) int64 (replicated across SP); cache_len: (B,) int32.
    cache: {'k','v'}, updated in place: the page pools (L, pages_loc, ps,
    Hkv, hd) with ``paged``, else the contiguous cache (L, B, S_local, Hkv,
    hd) of ``kv_cache``. Returns the next tokens (B, 1) int32, or with
    ``return_hidden`` the (B, 1, D) pre-head hidden state.

    sampling: None for greedy, or a dict of per-row ``temperature``,
      ``top_k``, ``top_p`` ((B,) device tensors) and ``seeds`` (B host
      request seeds, None for a row that draws no noise); needs
      ``paged``. Each seed's key is folded here with the
      sampled token's position, ``cache_len + 1``, from the host copy, so
      solo and batched serving draw the same noise."""
    x = blocks.embed(rt, model.embed, tokens, cfg, tokens_replicated=True)
    for i, layer in enumerate(model.layers):
        x = _attn_decode(rt, layer.mixer, x,
                         {"k": cache["k"][i], "v": cache["v"][i]}, cfg,
                         cache_len, paged)
        x = blocks.mlp_block(rt, layer.mlp, x, cfg)
    x = blocks.rmsnorm(model.final_norm, x, cfg.norm_eps)
    if return_hidden:
        return x
    if sampling is None:
        return sampling_lib.greedy(rt, model.head, x, cfg)
    if paged is None:
        raise ValueError("sampled decoding needs the paged tables' host "
                         "cache lengths (the engine's decode step)")
    keys = [None if s is None else sampling_lib.fold_in(
        sampling_lib.seed_key(s), int(cl) + 1)
        for s, cl in zip(sampling["seeds"], paged.cache_len)]
    return sampling_lib.sample(
        rt, model.head, x, cfg, temperature=sampling["temperature"],
        top_k=sampling["top_k"], top_p=sampling["top_p"], keys=keys)


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
    return sampling_lib.greedy(rt, model.head, last, cfg), cache


def _attn_prefill_paged(rt, p, x, cache, cfg: ModelConfig, cached_len: int,
                        table, cached, targets, page_size: int):
    """One attention layer of the suffix prefill.

    x: (1, S_loc, D), the prompt suffix (positions ``cached_len ..``),
      SP-sharded contiguously; cache: {'k','v'} this layer's pool slices,
      updated in place; table: (1, W) this rank's page-table row and
      cached: (1,) int32 ``cached_len``, on the device; targets:
      ``paged_cache.block_targets`` of the suffix.

    The suffix attends two disjoint key sets whose partials merge exactly:
      * the cached prefix, this rank's round-robin pages read in place
        (``dispatch.paged_prefill``: B6 on 'cuda') for every suffix query
        (all-gathered), merged across ranks with their lse;
      * the suffix itself, K/V all-gathered over SP, scored per rank
        (``dispatch.block_fwd`` with 1-D positions: B1 on 'cuda').
    The gathered suffix K/V then goes into this rank's own pages.
    """
    S_loc = x.shape[1]
    rank = rt.sp_rank()
    h = blocks.rmsnorm(p.norm, x, cfg.norm_eps)
    q, k, v = blocks.qkv(rt, p, h)
    pos_loc = cached_len + rt.positions_contig(S_loc)            # (S_loc,)
    q = blocks.rope(q, pos_loc, cfg.rope_theta)
    k = blocks.rope(k, pos_loc, cfg.rope_theta)
    kg = rt.all_gather_model(k, axis=1)              # (1, S_b, Hkv, hd)
    vg = rt.all_gather_model(v, axis=1)
    qg = rt.all_gather_model(q, axis=1)              # (1, S_b, Hq, hd)
    pos_all = cached_len + torch.arange(kg.shape[1], dtype=torch.int32,
                                        device=x.device)

    o_pre, lse_pre = kernels.paged_prefill(
        qg.contiguous(), cache["k"], cache["v"], table, cached, rank,
        sp=rt.sp_size(), page_size=page_size, window=cfg.window,
        impl=rt.kernel_impl)
    o_pre, lse_pre = st.combine_partials_with_lse(o_pre, lse_pre, rt.comm,
                                                  rt.sp_axes)
    lo = rank * S_loc
    o_pre, lse_pre = o_pre[:, lo:lo + S_loc], lse_pre[:, :, lo:lo + S_loc]

    o_suf, lse_suf = kernels.block_fwd(
        q.contiguous(), kg.contiguous(), vg.contiguous(), pos_loc, pos_all,
        causal=True, window=cfg.window, impl=rt.kernel_impl)
    o, _ = combine_pair(o_pre, lse_pre, o_suf, lse_suf)
    x = x + torch.einsum("bshk,hkd->bsd", o.to(x.dtype), rt.dense(p.wo))
    paged_cache.write_blocks(cache, kg[0], vg[0], targets)
    return x


def lm_prefill_paged(rt, model, tokens, cfg: ModelConfig, *, prompt_len: int,
                     cached_len: int, pools, table_row: np.ndarray,
                     page_size: int):
    """Prefix-cached prefill: forward only the prompt *suffix*, reading the
    cached prefix K/V from the paged pool and writing the suffix K/V into
    the reserved pages. Returns the (1, 1, D) hidden state of position
    ``prompt_len - 1``, replicated across SP.

    tokens: (1, S_loc) int64, this rank's slice of the suffix tokens
      (prompt positions ``cached_len .. prompt_len``); cached_len: tokens
      already in the pool, a multiple of ``page_size``; pools: {'k','v'}
      (L, pages_loc, ps, Hkv, hd), updated in place; table_row: (P_sp, W)
      host int32, the slot's page-table row.
    """
    dev = tokens.device
    rank = rt.sp_rank()
    table = torch.from_numpy(np.ascontiguousarray(
        table_row[rank][None])).to(dev)
    cached = torch.tensor([cached_len], dtype=torch.int32, device=dev)
    targets = paged_cache.block_targets(
        rt, table_row, cached_len, prompt_len - cached_len, page_size)
    x = blocks.embed(rt, model.embed, tokens, cfg)
    for i, layer in enumerate(model.layers):
        x = _attn_prefill_paged(
            rt, layer.mixer, x, {"k": pools["k"][i], "v": pools["v"][i]},
            cfg, cached_len, table, cached, targets, page_size)
        x = blocks.mlp_block(rt, layer.mlp, x, cfg)
    x = blocks.rmsnorm(model.final_norm, x, cfg.norm_eps)
    # prompt_len - 1 sits at suffix offset prompt_len - 1 - cached_len on
    # exactly one (rank, slot): a one-hot contraction plus psum broadcasts it
    pos = rt.positions_contig(x.shape[1])
    onehot = (pos == prompt_len - 1 - cached_len).float()[None]
    last = torch.einsum("bs,bsd->bd", onehot, x.float())[:, None]
    return rt.psum_model(last).to(x.dtype)


# ---------------------------------------------------------------------------
# the static-batch path (launch.serve --legacy)
# ---------------------------------------------------------------------------

def _contiguous_runtime(model, run_cfg: RunConfig, shape: ShapeConfig):
    """The runtime of one card with the caches' contiguous layout."""
    from repro_torch.train import step as train_step

    rt = train_step.make_runtime(model, run_cfg, shape)
    return dataclasses.replace(rt, st_cfg=dataclasses.replace(
        rt.st_cfg, seq_scheme="contiguous"))


def build_prefill_step(model, run_cfg: RunConfig, shape: ShapeConfig):
    """The prefill of a static batch at ``shape.seq_len`` tokens on one
    card: ``fn(tokens (B, S)) -> (next token (B, 1), cache {'k','v'}
    (L, B, S, Hkv, hd))``, the contiguous cache of ``kv_cache`` holding the
    prompt."""
    rt = _contiguous_runtime(model, run_cfg, shape)

    def fn(tokens):
        with torch.no_grad():
            tok, (k, v) = lm_prefill(rt, model, tokens, model.cfg)
        return tok, {"k": k, "v": v}

    return fn


def build_decode_step(model, run_cfg: RunConfig, shape: ShapeConfig):
    """One decode step of a static batch on one card against the contiguous
    cache of capacity ``shape.seq_len``: ``fn(cache, tokens (B, 1),
    cache_len (B,) int32, return_hidden=False) -> next token (B, 1)`` (or
    the hidden state), the cache updated in place. The JAX step fixes
    ``cache_len = seq_len - 1`` when it compiles; here each call passes the
    batch's true lengths."""
    rt = _contiguous_runtime(model, run_cfg, shape)

    def fn(cache, tokens, cache_len, return_hidden=False):
        with torch.no_grad():
            return lm_decode_step(rt, model, cache, tokens, model.cfg,
                                  cache_len, return_hidden=return_hidden)

    return fn
