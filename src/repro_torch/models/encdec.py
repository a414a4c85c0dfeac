"""Encoder-decoder model (the port's counterpart of ``repro.models.encdec``;
the seamless-m4t family).

Encoder: full-mask StarTrail self-attention + MLP over the frame
embeddings (the audio frontend is a stub: the batch carries the frames as
``frontend_emb``, (B, S_local, D), projected by ``frontend_proj``), then
``enc_norm``. Decoder: causal StarTrail self-attention, cross-attention,
MLP.

Cross-attention: the encoder K/V are static across decoding, so each
layer gathers them once over all SP axes (``Runtime.all_gather_model``,
whose backward is the psum-scatter: one all-gather, no ring) and the
queries attend locally and non-causally, ``pos_k = arange`` (the full
mask is order-free). In training it runs ``kernels.ops.flash_attention``
(kernel B1 forward and B3 backward on CUDA tensors).

Parameters (``encdec_specs``): ``frontend_proj`` (D, D), ``encoder[i]``
{attn, mlp}, ``enc_norm``, ``embed``, ``decoder[i]`` {attn, cross, mlp},
``final_norm`` and an untied ``lm_head``. The JAX tree stacks the
``encoder`` and ``decoder`` leaves along a leading layer dimension; the
port keeps one module a layer (``models.factory`` carries them across).

Recompute follows the JAX ``remat`` policies (``encdec_loss``): 'attn_out'
keeps each layer's input and its attention outputs (JAX's ``attn_out``
and ``cross_out``), one non-reentrant ``torch.utils.checkpoint`` region
around each sub-layer; 'full' keeps only each layer's input (one region a
layer); 'none' keeps every activation.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import blocks
from repro_torch.models.spec import PSpec
from repro_torch.models.transformer import REMATS

FRONTEND_AXES = ("embed_nosplit", "embed_out")


def cross_attention_specs(cfg: ModelConfig):
    return blocks.attention_specs(cfg)


def encdec_specs(cfg: ModelConfig):
    return {
        "frontend_proj": PSpec((cfg.d_model, cfg.d_model), FRONTEND_AXES),
        "encoder": [{"attn": blocks.attention_specs(cfg),
                     "mlp": blocks.mlp_specs(cfg)}
                    for _ in range(cfg.num_encoder_layers)],
        "enc_norm": blocks.rmsnorm_specs(cfg.d_model),
        "embed": blocks.embedding_specs(cfg),
        "decoder": [{"attn": blocks.attention_specs(cfg),
                     "cross": cross_attention_specs(cfg),
                     "mlp": blocks.mlp_specs(cfg)}
                    for _ in range(cfg.num_layers)],
        "final_norm": blocks.rmsnorm_specs(cfg.d_model),
        "lm_head": blocks.embedding_specs(cfg),
    }


def cross_kv(rt, p, enc_out):
    """The cross-attention's K and V (B, S_enc_local, Hkv, hd) of this
    rank's slice of the encoder output."""
    k = torch.einsum("bsd,dhk->bshk", enc_out, rt.dense(p.wk, blocks.KV_AXES))
    v = torch.einsum("bsd,dhk->bshk", enc_out, rt.dense(p.wv, blocks.KV_AXES))
    return k, v


def cross_query(rt, p, x, cfg: ModelConfig):
    h = blocks.rmsnorm(p.norm, x, cfg.norm_eps)
    return torch.einsum("bsd,dhk->bshk", h, rt.dense(p.wq, blocks.Q_AXES))


def cross_attention_block(rt, p, x, enc_out, cfg: ModelConfig):
    """x: (B, S_local, D) decoder; enc_out: (B, S_enc_local, D) this rank's
    encoder output. K/V gathered over the SP axes, attended non-causally
    (``ops.flash_attention``); with residual."""
    q = cross_query(rt, p, x, cfg)
    k, v = cross_kv(rt, p, enc_out)
    k = rt.all_gather_model(k, axis=1)
    v = rt.all_gather_model(v, axis=1)
    pos_q = rt.positions(q.shape[1])
    pos_k = torch.arange(k.shape[1], dtype=torch.int32, device=q.device)
    o = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            pos_q, pos_k, causal=False,
                            impl=rt.st_cfg.block_impl)
    return x + blocks.attention_out(rt, p, o)


def _stack(layers, x, sublayers, remat: str, *extra):
    """x through ``sublayers`` (each ``f(layer, x, *extra) -> x``) of
    every layer, under the recompute policy ``remat`` (module doc)."""
    if remat not in REMATS:
        raise ValueError(f"remat must be one of {REMATS}, got {remat!r}")

    def layer_fn(layer, x, *extra):
        for f in sublayers:
            x = f(layer, x, *extra)
        return x

    for layer in layers:
        if remat == "none" or not torch.is_grad_enabled():
            x = layer_fn(layer, x, *extra)
        elif remat == "attn_out":
            for f in sublayers:
                x = checkpoint(f, layer, x, *extra, use_reentrant=False)
        else:
            x = checkpoint(layer_fn, layer, x, *extra, use_reentrant=False)
    return x


def encode(rt, params, frames, cfg: ModelConfig, *, remat: str = "none"):
    """frames: (B, S_local, D) this rank's slice of the frame embeddings
    -> the encoder output (B, S_local, D) after ``enc_norm``. The
    encoder's length may differ from the decoder's (the runtime's
    ``seq_len``): its StarTrail runs at the frames' own length."""
    n = frames.shape[1] * rt.sp_size()
    if rt.st_cfg.seq_len != n:
        rt = dataclasses.replace(rt, st_cfg=dataclasses.replace(
            rt.st_cfg, seq_len=n))
    fp = rt.dense(params.frontend_proj, FRONTEND_AXES)
    x = torch.einsum("bsd,de->bse", frames.to(fp.dtype), fp)

    def attn(layer, x):
        return blocks.attention_block(rt, layer.attn, x, cfg, causal=False)

    def mlp(layer, x):
        return blocks.mlp_block(rt, layer.mlp, x, cfg)

    x = _stack(params.encoder, x, (attn, mlp), remat)
    return blocks.rmsnorm(params.enc_norm, x, cfg.norm_eps)


def decode(rt, params, tokens, enc_out, cfg: ModelConfig, *,
           remat: str = "none"):
    """tokens: (B, S_local) this rank's slice of the decoder tokens ->
    the hidden state (B, S_local, D) after ``final_norm``."""
    y = blocks.embed(rt, params.embed, tokens, cfg)

    def attn(layer, y, enc_out):
        return blocks.attention_block(rt, layer.attn, y, cfg, causal=True)

    def cross(layer, y, enc_out):
        return cross_attention_block(rt, layer.cross, y, enc_out, cfg)

    def mlp(layer, y, enc_out):
        return blocks.mlp_block(rt, layer.mlp, y, cfg)

    y = _stack(params.decoder, y, (attn, cross, mlp), remat, enc_out)
    return blocks.rmsnorm(params.final_norm, y, cfg.norm_eps)


def encdec_loss(rt, params, batch, cfg: ModelConfig, *,
                remat: str = "attn_out"):
    """batch: {frontend_emb (B, S, D), tokens (B, S), labels (B, S)}, this
    rank's slices; params: the rank's tree (``factory.shard_params``).
    Returns the scalar mean loss."""
    enc_out = encode(rt, params, batch["frontend_emb"], cfg, remat=remat)
    y = decode(rt, params, batch["tokens"], enc_out, cfg, remat=remat)
    return blocks.lm_head_logits_and_loss(rt, params.lm_head, y,
                                          batch["labels"], cfg)
