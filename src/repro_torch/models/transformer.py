"""Decoder LM assembly (the port's counterpart of ``repro.models.transformer``).

The JAX package scans a repeating *period* of sub-layers over stacked
parameters; PyTorch runs eagerly, so the port keeps one module per layer
(``layers[i].mixer`` / ``layers[i].mlp``) and loops, layer ``i`` taking
sub-layer ``i % len(period)`` of ``layer_pattern``. Dense stacks have a
period of one (attention, MLP); MoE stacks a period of
``moe.every_n_layers`` with the MoE block (``models.moe``, stored under
``mlp`` as in the JAX tree) on its last layer and a dense MLP on the others
(llama4-maverick: dense, then MoE); xLSTM stacks a period of
``xlstm.slstm_every`` recurrent mixers (``models.ssm``), an sLSTM on its
last layer and mLSTMs on the others, with no MLP (``d_ff == 0``): their
layers hold ``mixer`` only. Hybrid stacks (jamba) a period of
lcm(``attn_every``, ``moe.every_n_layers``) layers: attention on layer
``attn_every // 2`` of each ``attn_every``, the Mamba mixer
(``models.ssm.mamba_block``) on the others, and the MoE block on the last
layer of each ``every_n_layers``. An encoder-decoder config's decoder has
the dense period (attention, MLP: JAX's ``layer_pattern``); its stacks are
built and run by ``models.encdec``. A VLM stack (paligemma) has the
dense period; its patch prefix is ``lm_loss``'s (``frontend_emb``).

The depth cut (a port-only difference): a hybrid config whose
``num_layers`` is below one period takes the period's first ``num_layers``
layers, so a card can hold a cut of jamba's 8-layer period that keeps
every (mixer, MLP) kind. The JAX ``layer_pattern`` raises for it, so such
a stack has no JAX tree (``models.factory.jax_tree`` raises); every other
``num_layers`` that is not a multiple of the period raises as JAX's does.

``apply_stack`` returns ``(x, aux)``: the MoE layers' auxiliary losses with
the JAX weights, ``0.01 * moe_lb + 1e-3 * moe_z`` per MoE layer, summed;
``lm_loss`` returns the cross-entropy plus ``aux``.

Recompute follows the JAX ``remat`` policies (``apply_stack``), with
non-reentrant ``torch.utils.checkpoint`` regions in place of
``jax.checkpoint`` around each period. 'attn_out' (the default, as in the
JAX package) keeps per layer only the layer input and the attention
block's output (JAX's ``save_only_these_names("attn_out")``): one region
around ``attention_block`` and one around the MLP or MoE block (its aux
losses among the region's outputs), so each layer's attention forward, and
each MoE block with its all-to-alls, runs twice per step. A layer with a
recurrent mixer has no attention output to keep: one region around the
mixer keeps only its input, as JAX's policy does for a period without
attention. 'full' keeps only the layer input (one region around the
layer); 'none' keeps every activation. Recompute changes no value.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks, moe, ssm

REMATS = ("none", "attn_out", "full")
# the aux-loss weights of a MoE layer (JAX ``apply_stack``)
LB_WEIGHT, Z_WEIGHT = 0.01, 1e-3


def period_length(cfg: ModelConfig) -> int:
    """The number of layers of one period (JAX ``layer_pattern``'s)."""
    period = 1
    if cfg.moe is not None:
        period = max(period, cfg.moe.every_n_layers)
    if cfg.family == "hybrid":
        period = max(period, cfg.attn_every)
        if cfg.moe is not None:
            period = math.lcm(cfg.attn_every, cfg.moe.every_n_layers)
    if cfg.family == "ssm" and cfg.xlstm is not None:
        period = max(period, cfg.xlstm.slstm_every)
    return period


def cut_below_period(cfg: ModelConfig) -> bool:
    """Whether ``cfg`` is a hybrid stack cut to fewer layers than one
    period (the port-only depth cut of the module doc)."""
    return cfg.family == "hybrid" and cfg.num_layers < period_length(cfg)


def layer_pattern(cfg: ModelConfig) -> List[Tuple[str, Optional[str]]]:
    """The repeating (mixer, mlp) period of the architecture (JAX
    ``layer_pattern``): (attn, mlp) for a dense stack; for a MoE stack
    ``every_n_layers`` attention layers with 'moe' on the last; for xLSTM
    ``slstm_every`` layers, 'slstm' on the last and 'mlstm' on the others,
    each with no MLP; for a hybrid stack Mamba and attention layers, MLP
    or MoE (module doc). A hybrid stack cut below one period gets the
    period's first ``num_layers`` layers, where JAX raises."""
    period = period_length(cfg)
    if cut_below_period(cfg):
        period = cfg.num_layers
    if cfg.num_layers % period:
        raise ValueError(f"{cfg.num_layers=} not divisible by {period=}")
    pat = []
    for i in range(period):
        if cfg.d_ff == 0 and cfg.moe is None:
            mlp = None                      # xLSTM blocks have no FFN
        elif cfg.moe_on_layer(i):
            mlp = "moe"
        else:
            mlp = "mlp"
        pat.append((cfg.mixer_on_layer(i), mlp))
    return pat


def layer_plan(cfg: ModelConfig) -> List[Tuple[str, Optional[str]]]:
    """Each layer's (mixer, mlp) kinds, in stack order."""
    pat = layer_pattern(cfg)
    return [pat[i % len(pat)] for i in range(cfg.num_layers)]


def has_moe(cfg: ModelConfig) -> bool:
    return any(mlp == "moe" for _, mlp in layer_pattern(cfg))


def layer_kinds(cfg: ModelConfig) -> List[Optional[str]]:
    """Each layer's MLP kind, 'mlp', 'moe' or None (no MLP), in stack
    order."""
    return [mlp for _, mlp in layer_plan(cfg)]


def _layer_specs(cfg: ModelConfig, mixer: str, mlp: Optional[str]):
    s = {"mixer": (blocks.attention_specs(cfg) if mixer == "attn"
                   else ssm.MIXERS[mixer][0](cfg))}
    if mlp == "moe":
        s["mlp"] = moe.moe_specs(cfg)
    elif mlp == "mlp":
        s["mlp"] = blocks.mlp_specs(cfg)
    return s


def lm_specs(cfg: ModelConfig):
    s = {
        "embed": blocks.embedding_specs(cfg),
        "layers": [_layer_specs(cfg, mixer, mlp)
                   for mixer, mlp in layer_plan(cfg)],
        "final_norm": blocks.rmsnorm_specs(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = blocks.embedding_specs(cfg)
    return s


def mlp_sublayer(rt, p, x, cfg: ModelConfig, kind: str):
    """The layer's MLP ('mlp') or MoE block ('moe') with residual ->
    (x, aux), aux the MoE layer's weighted auxiliary loss (None for 'mlp')."""
    if kind == "moe":
        x, aux = moe.moe_block(rt, p, x, cfg)
        return x, LB_WEIGHT * aux["moe_lb"] + Z_WEIGHT * aux["moe_z"]
    return blocks.mlp_block(rt, p, x, cfg), None


def apply_stack(rt, layers, x, cfg: ModelConfig, *, causal: bool = True,
                prefix_len=None, remat: str = "attn_out"):
    """x: (B, S_local, D) -> (x, aux) through every layer, under the
    recompute policy ``remat`` ('none' | 'attn_out' | 'full'; it only
    matters while autograd records): aux is the f32 sum of the MoE layers'
    weighted auxiliary losses (0 for a dense stack)."""
    if remat not in REMATS:
        raise ValueError(f"remat must be one of {REMATS}, got {remat!r}")

    def mix(p, x, mixer):
        if mixer == "attn":
            return blocks.attention_block(rt, p, x, cfg, causal=causal,
                                          window=cfg.window,
                                          prefix_len=prefix_len)
        return ssm.MIXERS[mixer][1](rt, p, x, cfg)

    def mlp(layer, x, kind):
        if kind is None:
            return x, None
        return mlp_sublayer(rt, layer.mlp, x, cfg, kind)

    def layer_fn(layer, x, mixer, kind):
        return mlp(layer, mix(layer.mixer, x, mixer), kind)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer, (mixer, kind) in zip(layers, layer_plan(cfg)):
        if remat == "none" or not torch.is_grad_enabled():
            x, a = layer_fn(layer, x, mixer, kind)
        elif remat == "attn_out":
            x = checkpoint(mix, layer.mixer, x, mixer, use_reentrant=False)
            x, a = (checkpoint(mlp, layer, x, kind, use_reentrant=False)
                    if kind is not None else (x, None))
        else:
            x, a = checkpoint(layer_fn, layer, x, mixer, kind,
                              use_reentrant=False)
        if a is not None:
            aux = aux + a
    return x, aux


def patch_prefix(rt, x, frontend_emb, cfg: ModelConfig):
    """The VLM's image prefix (JAX ``lm_loss``, op for op): the positions
    of this rank's tokens below ``prefix_len = int(prefix_len_frac *
    seq_len)`` take the patch embeddings ``frontend_emb`` (B, S_local, D)
    in place of the token embeddings ``x``. Returns ``(x, prefix_len,
    is_prefix)``, ``is_prefix`` the (S_local,) bool of those positions."""
    prefix_len = int(cfg.prefix_len_frac * rt.st_cfg.seq_len)
    is_prefix = rt.positions(x.shape[1]) < prefix_len
    x = torch.where(is_prefix[None, :, None], frontend_emb.to(x.dtype), x)
    return x, prefix_len, is_prefix


def lm_loss(rt, params, batch, cfg: ModelConfig, *,
            remat: str = "attn_out"):
    """batch: {tokens, labels[, frontend_emb]} (this rank's sequence
    slice); params: the rank's parameter tree (``factory.shard_params``).
    Returns the scalar mean loss plus the MoE layers' auxiliary losses.
    With ``frontend_emb`` (B, S_local, D) a VLM's patches replace the
    prefix positions' embeddings (``patch_prefix``), every attention layer
    sees the prefix bidirectionally, and the prefix positions leave the
    loss (JAX ``lm_loss``)."""
    tokens = batch["tokens"]
    x = blocks.embed(rt, params.embed, tokens, cfg)
    prefix_len = loss_mask = None
    if cfg.frontend_stub is not None and "frontend_emb" in batch:
        x, prefix_len, is_prefix = patch_prefix(rt, x, batch["frontend_emb"],
                                                cfg)
        loss_mask = (1.0 - is_prefix.float())[None].expand(
            tokens.shape).contiguous()
    x, aux = apply_stack(rt, params.layers, x, cfg, causal=True,
                         prefix_len=prefix_len, remat=remat)
    x = blocks.rmsnorm(params.final_norm, x, cfg.norm_eps)
    return blocks.lm_head_logits_and_loss(rt, params.head, x,
                                          batch["labels"], cfg,
                                          mask=loss_mask) + aux
