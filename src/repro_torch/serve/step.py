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

Recurrent mixers (``models.ssm``: the xLSTM family, and the Mamba layers
  of the hybrid family beside its attention layers): the decode step
  advances a Mamba layer's conv window and SSM state, an mLSTM's matrix
  memory or an sLSTM's (h, c) by one token in place (``_mamba_decode``,
  ``_mlstm_decode``, ``_slstm_decode``); the prefill returns each such
  layer's state, the last rank's: a Mamba layer's last raw conv inputs and
  its cross-shard-corrected final state, an mLSTM's corrected final state,
  an sLSTM's shard-local (h, c). Only the static-batch path serves them:
  the engine refuses them, as JAX's does.

Encoder-decoder stacks (``models.encdec``, seamless-m4t): the prefill is
  the encoder's forward over the frames (``encdec_prefill``: full-mask
  StarTrail, B2 on every ring step), whose output each rank keeps, its
  contiguous slice at the encoder's own length, as the cache's
  ``enc_out``; the decode step (``encdec_decode_step``) runs each decoder
  layer's self-attention against the contiguous K/V cache, then its
  cross-attention (``_cross_decode``: K/V recomputed from ``enc_out`` on
  every step, as the JAX step does; at P = 1 one ``dispatch.prefill``, B1
  with one query row, at P > 1 ``startrail.decode_attention`` over each
  rank's slice, merged with the lse), then the MLP. There is no decoder
  prefill (nor in the JAX package): the static-batch path feeds a decoder
  prompt through decode steps. Only the static-batch path serves them.

VLM stacks (paligemma): ``lm_prefill`` takes the rank's slice of the
  patch embeddings (``frontend_emb``), which replace the embeddings of the
  prompt's first ``int(prefix_len_frac * seq_len)`` positions, and every
  attention layer sees that prefix bidirectionally (B2 with the prefix-LM
  mask); the decode steps need no prefix (``prefix_len=None``, as JAX's):
  the causal mask already shows every prefix key to a later query.

Dense and MoE attention stacks are ported: a MoE layer runs
``models.moe.moe_block`` in place of the MLP in the decode step and the
full prefill, its auxiliary losses dropped, and its expert capacity couples
the rows of one call (the decode batch, the padded prompt), as in the JAX
package. The suffix prefill never sees a MoE stack: the engine refuses
prefix caching and chunking for them. The per-rank functions take the
``Runtime`` (communicator + attention config) and the rank's parameter
tree (``models.factory.shard_params`` under ``rt.rules``; at one rank the
``Model`` itself). ``build_prefill_step`` / ``build_decode_step`` run them
on one card, on every rank of a ``ThreadMesh``, or on a rank process's own
rank of a ``ProcessComm`` mesh (its ``rank_model``; ``StaticSteps``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

import torch.nn.functional as F

from repro_torch.configs.base import (MambaConfig, ModelConfig, RunConfig,
                                      ShapeConfig)
from repro_torch.core import startrail as st
from repro_torch.core.combine import combine_pair
from repro_torch.engine import paged_cache
from repro_torch.engine import sampling as sampling_lib
from repro_torch.kernels import dispatch as kernels
from repro_torch.dist.comm import ProcessComm
from repro_torch.dist.sharding import DATA_AXIS
from repro_torch.models import blocks, encdec, ssm, transformer
from repro_torch.models.factory import run_on_ranks
from repro_torch.serve import kv_cache


def _attn_decode(rt, p, x, cache, cfg: ModelConfig, cache_len,
                 paged: Optional[paged_cache.PagedTables]):
    """x: (B, 1, D) replicated over SP; cache_len: (B,) int32 device
    tensor, the new token's position. cache: {'k','v'} this layer's pool
    slices (pages_loc, page_size, Hkv, hd) when ``paged`` is given, else its
    contiguous cache slices (B, S_local, Hkv, hd); updated in place."""
    return x + attn_decode_branch(rt, p, x, cache, cfg, cache_len, paged)


def attn_decode_branch(rt, p, x, cache, cfg: ModelConfig, cache_len,
                       paged: Optional[paged_cache.PagedTables]):
    """``_attn_decode`` less its residual add: the attention's output
    projection (B, 1, D), the new token written into ``cache``."""
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
    return blocks.attention_out(rt, p, o)


def _mamba_decode(rt, p, x, cache, cfg: ModelConfig):
    """One token through a Mamba layer. x: (B, 1, D); cache: {'conv'}
    (B, d_conv - 1, d_inner), the last raw conv inputs, and {'state'}
    (B, Hm, N, P) f32, both updated in place."""
    m = cfg.mamba or MambaConfig()
    B = x.shape[0]
    di = m.expand * cfg.d_model
    hm = di // m.head_dim

    xin, z, Bc, Cc, dt_raw = ssm.mamba_in(rt, p, x, cfg)
    window = torch.cat([cache["conv"], xin], dim=1)        # (B, K, di)
    w = rt.dense(p.conv_w, ssm.CONV_AXES).float()
    xc = torch.einsum("bkc,kc->bc", window.float(), w)[:, None]
    xc = F.silu(xc)
    cache["conv"].copy_(window[:, 1:])

    dt = F.softplus(dt_raw.float()
                    + rt.dense(p.dt_bias, ssm.STATE_AXES).float())  # (B,1,Hm)
    a_log = rt.dense(p.A_log, ssm.STATE_AXES).float()
    decay = torch.exp(-torch.exp(a_log) * dt)[:, 0]
    xh = xc.reshape(B, hm, m.head_dim)
    v = xh * dt[:, 0, :, None]
    state = cache["state"] * decay[..., None, None] + torch.einsum(
        "bn,bhp->bhnp", Bc[:, 0].float(), v)
    cache["state"].copy_(state)
    y = torch.einsum("bn,bhnp->bhp", Cc[:, 0].float(), state)
    y = y + rt.dense(p.D_skip, ssm.STATE_AXES).float()[None, :, None] * xh
    return ssm.mamba_out(rt, p, x, y.reshape(B, 1, di), z, cfg)


def _mlstm_decode(rt, p, x, cache, cfg: ModelConfig):
    """One token through an mLSTM layer. x: (B, 1, D); cache: {'state'}
    (B, H, dk, dk + 1) f32, updated in place."""
    B = x.shape[0]
    h = blocks.rmsnorm(p.norm, x, cfg.norm_eps)
    wq = rt.dense(p.wq, ssm.QKV_AXES)
    wk = rt.dense(p.wk, ssm.QKV_AXES)
    wv = rt.dense(p.wv, ssm.QKV_AXES)
    wi = rt.dense(p.wi, ssm.GATE_AXES)
    wf = rt.dense(p.wf, ssm.GATE_AXES)
    wo = rt.dense(p.wo, ssm.O_AXES)
    dk = wq.shape[-1]

    h1 = h[:, :1]
    q = torch.einsum("bsd,dhk->bhk", h1, wq) * dk ** -0.5
    k = torch.einsum("bsd,dhk->bhk", h1, wk)
    v = torch.einsum("bsd,dhk->bhk", h1, wv)
    ig = torch.sigmoid(torch.einsum("bsd,dh->bh", h1, wi).float())
    f = torch.sigmoid(torch.einsum("bsd,dh->bh", h1, wf).float())

    k = k.float() * ig[..., None]
    v_aug = torch.cat([v.float(), torch.ones((B, v.shape[1], 1),
                                             dtype=torch.float32,
                                             device=v.device)], dim=-1)
    state = cache["state"] * f[..., None, None] \
        + k[..., :, None] * v_aug[..., None, :]
    cache["state"].copy_(state)
    y_aug = torch.einsum("bhk,bhkp->bhp", q.float(), state)
    y, ndot = y_aug[..., :-1], y_aug[..., -1]
    y = y / torch.clamp(ndot.abs(), min=1.0)[..., None]
    return x + torch.einsum("bhk,hkd->bd", y.to(x.dtype), wo)[:, None]


def _slstm_decode(rt, p, x, cache, cfg: ModelConfig):
    """One token through an sLSTM layer. x: (B, 1, D); cache: {'h','c'}
    (B, H, dh) f32, updated in place. ``r`` is gathered whole
    (``ssm.slstm_recurrent_weight``)."""
    B = x.shape[0]
    hq = cfg.num_heads
    dh = cfg.d_model // hq
    h = blocks.rmsnorm(p.norm, x, cfg.norm_eps)
    wx = rt.dense(p.wx, ssm.WX_AXES)
    r = ssm.slstm_recurrent_weight(rt, p)
    wo = rt.dense(p.wo, ssm.SO_AXES)

    gx = torch.einsum("bsd,dg->bg", h[:, :1], wx).float()
    hs, cs = ssm.slstm_cell(gx.reshape(B, hq, 4 * dh), cache["h"],
                            cache["c"], r)
    cache["h"].copy_(hs)
    cache["c"].copy_(cs)
    y = hs.reshape(B, 1, cfg.d_model).to(x.dtype)
    return x + torch.einsum("bsd,de->bse", y, wo)


_RECURRENT_DECODE = {"mamba": _mamba_decode, "mlstm": _mlstm_decode,
                     "slstm": _slstm_decode}


def lm_decode_step(rt, params, cache, tokens, cfg: ModelConfig, cache_len,
                   paged: Optional[paged_cache.PagedTables] = None,
                   return_hidden: bool = False, sampling=None):
    """tokens: (B, 1) int64 (replicated across SP); cache_len: (B,) int32.
    cache: updated in place: the page pools {'k','v'} (L, pages_loc, ps,
    Hkv, hd) with ``paged``, else the contiguous cache of ``kv_cache``
    (its recurrent states too). Returns the next tokens (B, 1) int32, or with
    ``return_hidden`` the (B, 1, D) pre-head hidden state.

    sampling: None for greedy, or a dict of per-row ``temperature``,
      ``top_k``, ``top_p`` ((B,) device tensors) and ``seeds`` (B host
      request seeds, None for a row that draws no noise); needs
      ``paged``. Each seed's key is folded here with the
      sampled token's position, ``cache_len + 1``, from the host copy, so
      solo and batched serving draw the same noise."""
    x = blocks.embed(rt, params.embed, tokens, cfg, tokens_replicated=True)
    for i, (layer, (mixer, kind)) in enumerate(zip(
            params.layers, transformer.layer_plan(cfg))):
        c = kv_cache.layer(cache, i)
        if mixer == "attn":
            x = _attn_decode(rt, layer.mixer, x, c, cfg, cache_len, paged)
        else:
            x = _RECURRENT_DECODE[mixer](rt, layer.mixer, x, c, cfg)
        if kind is not None:
            x = transformer.mlp_sublayer(rt, layer.mlp, x, cfg, kind)[0]
    x = blocks.rmsnorm(params.final_norm, x, cfg.norm_eps)
    if return_hidden:
        return x
    if sampling is None:
        return sampling_lib.greedy(rt, params.head, x, cfg)
    if paged is None:
        raise ValueError("sampled decoding needs the paged tables' host "
                         "cache lengths (the engine's decode step)")
    keys = [None if s is None else sampling_lib.fold_in(
        sampling_lib.seed_key(s), int(cl) + 1)
        for s, cl in zip(sampling["seeds"], paged.cache_len)]
    return sampling_lib.sample(
        rt, params.head, x, cfg, temperature=sampling["temperature"],
        top_k=sampling["top_k"], top_p=sampling["top_p"], keys=keys)


def _cross_decode(rt, p, x, enc_out, cfg: ModelConfig):
    """Cross-attention of one decoder token per row against the encoder
    output, with residual. x: (B, 1, D) replicated over SP; enc_out: (B,
    S_enc_local, D) this rank's contiguous slice; non-causal, so every
    encoder position is visible."""
    q = encdec.cross_query(rt, p, x, cfg).contiguous()
    k, v = encdec.cross_kv(rt, p, enc_out)
    k, v = k.contiguous(), v.contiguous()
    pos_k = rt.positions_contig(k.shape[1])
    pos_q = torch.zeros((1,), dtype=torch.int32, device=x.device)
    if rt.sp_size() == 1:
        o = kernels.prefill(q, k, v, pos_q, pos_k, causal=False,
                            impl=rt.st_cfg.block_impl)
    else:
        cfg_st = dataclasses.replace(rt.st_cfg, causal=False, window=None,
                                     prefix_len=None)
        o = st.decode_attention(q, k, v, pos_q, pos_k, cfg_st, rt.comm)
    return x + blocks.attention_out(rt, p, o)


def encdec_decode_step(rt, params, cache, tokens, cfg: ModelConfig,
                       cache_len, return_hidden: bool = False):
    """The decoder's decode step against the contiguous cache
    (``kv_cache``: the decoder's {'k','v'}, updated in place, and the
    encoder's ``enc_out``). tokens: (B, 1) int64 replicated across SP;
    cache_len: (B,) int32, the new token's position. Returns the next
    greedy tokens (B, 1) int32, or with ``return_hidden`` the (B, 1, D)
    pre-head hidden state."""
    enc_out = cache["enc_out"]
    x = blocks.embed(rt, params.embed, tokens, cfg, tokens_replicated=True)
    for i, layer in enumerate(params.decoder):
        x = _attn_decode(rt, layer.attn, x, kv_cache.layer(cache, i), cfg,
                         cache_len, None)
        x = _cross_decode(rt, layer.cross, x, enc_out, cfg)
        x = blocks.mlp_block(rt, layer.mlp, x, cfg)
    x = blocks.rmsnorm(params.final_norm, x, cfg.norm_eps)
    if return_hidden:
        return x
    return sampling_lib.greedy(rt, params.head, x, cfg)


def encdec_prefill(rt, params, frames, cfg: ModelConfig):
    """The encoder's forward (the serving entry of the family): frames
    (B, S_local, D), this rank's contiguous slice of the frame embeddings
    -> its slice of the encoder output (B, S_local, D), the cache's
    ``enc_out``."""
    return encdec.encode(rt, params, frames, cfg)


def lm_prefill(rt, params, tokens, cfg: ModelConfig,
               prompt_len: Optional[torch.Tensor] = None,
               return_hidden: bool = False, frontend_emb=None):
    """Full forward pass over the prompt, collecting the serving cache.

    tokens: (B, S_local) int64, this rank's contiguous slice of the prompt
      of ``rt.st_cfg.seq_len`` tokens (right-padded, if at all, past the
      real length). Returns
      ``(next_token or hidden, cache)``, the cache in ``kv_cache``'s
      layout over the rank's S_local positions: K/V post-RoPE, each
      recurrent layer's state from ``return_state``.
    prompt_len: optional (B,) int32 real prompt lengths; the next-token
      hidden state is then taken at ``prompt_len - 1`` instead of the last
      slot. Causal attention makes right-padding harmless before it.
    return_hidden: return the (B, 1, D) pre-head hidden state (replicated
      across SP) instead of a greedily sampled token.
    frontend_emb: a VLM's (B, S_local, D) patch embeddings, this rank's
      contiguous slice: the prompt's first ``int(prefix_len_frac *
      rt.st_cfg.seq_len)`` positions take them and form the bidirectional
      prefix (JAX ``lm_prefill``).
    """
    x = blocks.embed(rt, params.embed, tokens, cfg)
    prefix_len = None
    if cfg.frontend_stub is not None and frontend_emb is not None:
        x, prefix_len, _ = transformer.patch_prefix(rt, x, frontend_emb, cfg)
    caches = []
    for layer, (mixer, kind) in zip(params.layers,
                                    transformer.layer_plan(cfg)):
        if mixer == "attn":
            x, (k, v) = blocks.attention_block(
                rt, layer.mixer, x, cfg, causal=True, window=cfg.window,
                prefix_len=prefix_len, return_kv=True)
            caches.append({"k": k, "v": v})
        else:
            x, state = ssm.MIXERS[mixer][1](rt, layer.mixer, x, cfg,
                                            return_state=True)
            caches.append(state)
        if kind is not None:
            x = transformer.mlp_sublayer(rt, layer.mlp, x, cfg, kind)[0]
    x = blocks.rmsnorm(params.final_norm, x, cfg.norm_eps)
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
    cache = kv_cache.from_layers(cfg, caches)
    if return_hidden:
        return last, cache
    return sampling_lib.greedy(rt, params.head, last, cfg), cache


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
    x = x + blocks.attention_out(rt, p, o.to(x.dtype))
    paged_cache.write_blocks(cache, kg[0], vg[0], targets)
    return x


def lm_prefill_paged(rt, params, tokens, cfg: ModelConfig, *, prompt_len: int,
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
    # MoE capacity couples the prefix's tokens to the suffix: the engine
    # refuses prefix caching and chunking for MoE stacks, as JAX's does
    assert not transformer.has_moe(cfg), "prefix-cached prefill excludes MoE"
    dev = tokens.device
    rank = rt.sp_rank()
    table = torch.from_numpy(np.ascontiguousarray(
        table_row[rank][None])).to(dev)
    cached = torch.tensor([cached_len], dtype=torch.int32, device=dev)
    targets = paged_cache.block_targets(
        rt, table_row, cached_len, prompt_len - cached_len, page_size)
    x = blocks.embed(rt, params.embed, tokens, cfg)
    for i, layer in enumerate(params.layers):
        x = _attn_prefill_paged(
            rt, layer.mixer, x, {"k": pools["k"][i], "v": pools["v"][i]},
            cfg, cached_len, table, cached, targets, page_size)
        x = blocks.mlp_block(rt, layer.mlp, x, cfg)
    x = blocks.rmsnorm(params.final_norm, x, cfg.norm_eps)
    # prompt_len - 1 sits at suffix offset prompt_len - 1 - cached_len on
    # exactly one (rank, slot): a one-hot contraction plus psum broadcasts it
    pos = rt.positions_contig(x.shape[1])
    onehot = (pos == prompt_len - 1 - cached_len).float()[None]
    last = torch.einsum("bs,bsd->bd", onehot, x.float())[:, None]
    return rt.psum_model(last).to(x.dtype)


# ---------------------------------------------------------------------------
# the static-batch path (launch.serve --legacy)
# ---------------------------------------------------------------------------

class StaticSteps:
    """The ranks of the static-batch steps of one ``shape``
    (``build_prefill_step`` / ``build_decode_step``): one card when
    ``mesh`` is None, every thread of a ``ThreadMesh``, or, when ``mesh``
    is this process's ``ProcessComm``, its own rank alone (``comm``;
    ``model`` its ``rank_model``): its results and ``where`` have one
    entry, and ``gather`` and ``kv_cache.fill_from_prefill`` cross ranks
    by collectives. Each rank serves its data replica's rows (the batch
    splits over the replicas when it divides, else every replica serves
    it all) and its contiguous slice of the sequence, with its parameter
    tree under the plan's rules (built at its first call). ``where`` gives
    each rank's (data replica, SP rank)."""

    def __init__(self, model, run_cfg: RunConfig, shape: ShapeConfig,
                 mesh=None):
        from repro_torch.train import step as train_step

        self.comm = mesh if isinstance(mesh, ProcessComm) else None
        self.model = model
        self.mesh = None if self.comm is not None else mesh
        data = mesh.data if mesh is not None else 1
        # split the batch over the replicas when it divides, else every
        # replica serves every row (JAX ``batch_axes_for``)
        self.split = data > 1 and shape.global_batch % data == 0
        self.rows = shape.global_batch // data if self.split \
            else shape.global_batch
        rt = train_step.make_runtime(model, run_cfg, shape, self.comm)
        self.rt = dataclasses.replace(
            rt, batch_axes=(DATA_AXIS,) if self.split else (),
            st_cfg=dataclasses.replace(rt.st_cfg, seq_scheme="contiguous"))
        self._trees = [None] * (self.mesh.size if self.mesh is not None
                                else 1)
        self.where = self.run(lambda rt, *_: (
            rt.comm.axis_index(DATA_AXIS), rt.sp_rank()))

    def run(self, fn) -> List:
        """``fn(rt, rank, tree)`` on every rank under ``no_grad``, the
        results in rank order (``models.factory.run_on_ranks``)."""
        return run_on_ranks(self.mesh, self.rt, self.model, self._trees, fn)

    def rows_of(self, rt, x):
        """The rows of ``x`` (batch-major) the rank of ``rt`` serves."""
        if not self.split:
            return x
        d = rt.comm.axis_index(DATA_AXIS)
        return x[d * self.rows:(d + 1) * self.rows]

    def groups(self) -> List[List[int]]:
        """Each data replica's ranks, in SP rank order."""
        n = max(d for d, _ in self.where) + 1
        return [[rank for _, rank in sorted(
            (sp, rank) for rank, (d, sp) in enumerate(self.where)
            if d == dd)] for dd in range(n)]

    def gather(self, outs):
        """The batch's rows of a per-rank output: each serving replica's
        SP rank 0's, in replica order (replica 0's alone when every
        replica serves every row). A rank process's SP ranks hold the same
        rows, and the replicas' rows cross by an all-gather over ``data``,
        off the ledger (a ``ThreadMesh`` reads them from shared memory)."""
        if self.comm is not None:
            if not self.split:
                return outs[0]
            with self.comm.ledger.uncounted():
                return self.comm.all_gather(outs[0], DATA_AXIS, 0)
        groups = self.groups() if self.split else self.groups()[:1]
        return torch.cat([outs[g[0]] for g in groups])

    def fill(self, caches, caches_p, prompt_len: int) -> None:
        """``kv_cache.fill_from_prefill`` of every data replica: the
        prefill caches ``caches_p`` into the capacity caches ``caches``
        (both per rank, in rank order). A rank process first gathers its
        replica's prefill K/V over the SP axes, off the ledger."""
        cfg = self.model.cfg
        if self.comm is None:
            for group in self.groups():
                kv_cache.fill_from_prefill(
                    cfg, [caches[r] for r in group],
                    [caches_p[r] for r in group], prompt_len)
            return
        with self.comm.ledger.uncounted():
            src = kv_cache.gather_prefill(self.rt, cfg, caches_p[0])
        kv_cache.fill_from_prefill(cfg, caches, src, prompt_len,
                                   ranks=[self.rt.sp_rank()])


def build_prefill_step(model, run_cfg: RunConfig, shape: ShapeConfig,
                       mesh=None):
    """The prefill of a static batch at ``shape.seq_len`` tokens (a
    multiple of the SP degree): ``fn(tokens (B, S)) -> (next token (B, 1),
    caches)``, ``caches`` every rank's ``kv_cache`` cache holding its
    slice of the prompt, in rank order (one on one card). For an
    encoder-decoder, ``fn(frames (B, S, D)) -> enc_outs``: every rank's
    slice of the encoder output (``encdec_prefill``), in rank order, as
    the JAX island returns it sharded. A VLM takes ``fn(tokens,
    frontend_emb (B, S, D))``: each rank gets its contiguous slice of the
    patches (JAX's ``P(b, seq, None)``). ``fn.steps`` is its
    ``StaticSteps``."""
    steps = StaticSteps(model, run_cfg, shape, mesh)
    cfg = model.cfg
    forward = encdec_prefill if cfg.encdec else lm_prefill

    def fn(tokens, frontend_emb=None):
        sp = mesh.sp_size if mesh is not None else 1
        if tokens.shape[1] % sp:
            raise ValueError(f"prompt of {tokens.shape[1]} tokens does not "
                             f"split over {sp} SP ranks")

        def rank_fn(rt, _, tree):
            s = tokens.shape[1] // rt.sp_size()
            cols = slice(rt.sp_rank() * s, (rt.sp_rank() + 1) * s)
            own = steps.rows_of(rt, tokens)[:, cols]
            if frontend_emb is not None:
                return forward(rt, tree, own, cfg, frontend_emb=steps.rows_of(
                    rt, frontend_emb)[:, cols])
            return forward(rt, tree, own, cfg)

        out = steps.run(rank_fn)
        if cfg.encdec:
            return out
        return steps.gather([t for t, _ in out]), [c for _, c in out]

    fn.steps = steps
    return fn


def build_decode_step(model, run_cfg: RunConfig, shape: ShapeConfig,
                      mesh=None):
    """One decode step of a static batch against the contiguous caches of
    capacity ``shape.seq_len``: ``fn(caches, tokens (B, 1), cache_len (B,)
    int32, return_hidden=False) -> next token (B, 1)`` (or the hidden
    state), ``caches`` every rank's, in rank order (one on one card),
    updated in place. The JAX step fixes ``cache_len = seq_len - 1`` when
    it compiles; here each call passes the batch's true lengths. An
    encoder-decoder runs ``encdec_decode_step`` against each rank's
    ``enc_out``. ``fn.steps`` is its ``StaticSteps``."""
    steps = StaticSteps(model, run_cfg, shape, mesh)
    step = encdec_decode_step if model.cfg.encdec else lm_decode_step

    def fn(caches, tokens, cache_len, return_hidden=False):
        return steps.gather(steps.run(lambda rt, rank, tree: step(
            rt, tree, caches[rank], steps.rows_of(rt, tokens), model.cfg,
            steps.rows_of(rt, cache_len), return_hidden=return_hidden)))

    fn.steps = steps
    return fn
