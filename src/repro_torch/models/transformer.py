"""Decoder LM assembly (the port's counterpart of ``repro.models.transformer``).

The JAX package scans a repeating *period* of sub-layers over stacked
parameters; PyTorch runs eagerly, so the port keeps one module per layer
(``layers[i].mixer`` / ``layers[i].mlp``) and loops. Only dense,
all-attention stacks are ported; MoE, hybrid and SSM periods raise, naming
the ROADMAP queue.

Recompute follows the JAX ``remat`` policies (``apply_stack``), with
non-reentrant ``torch.utils.checkpoint`` regions in place of
``jax.checkpoint`` around each period. 'attn_out' (the default, as in the
JAX package) keeps per layer only the layer input and the attention
block's output (JAX's ``save_only_these_names("attn_out")``): one region
around ``attention_block`` and one around ``mlp_block``, so each layer's
attention forward runs twice per step. 'full' keeps only the layer input
(one region around the layer); 'none' keeps every activation. Recompute
changes no value.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks

REMATS = ("none", "attn_out", "full")


def layer_pattern(cfg: ModelConfig) -> List[Tuple[str, Optional[str]]]:
    """The repeating (mixer, mlp) period of the architecture: (attn, mlp)
    for every layer of a dense stack."""
    if (cfg.moe is not None or cfg.family != "dense" or cfg.encdec
            or cfg.d_ff == 0):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (MoE / hybrid / SSM / "
            "encoder-decoder layers) is not ported to repro_torch yet "
            "(ROADMAP.md §A: remaining model families)")
    return [("attn", "mlp")]


def lm_specs(cfg: ModelConfig):
    layer_pattern(cfg)
    s = {
        "embed": blocks.embedding_specs(cfg),
        "layers": [{"mixer": blocks.attention_specs(cfg),
                    "mlp": blocks.mlp_specs(cfg)}
                   for _ in range(cfg.num_layers)],
        "final_norm": blocks.rmsnorm_specs(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = blocks.embedding_specs(cfg)
    return s


def apply_stack(rt, layers, x, cfg: ModelConfig, *, causal: bool = True,
                prefix_len=None, remat: str = "attn_out"):
    """x: (B, S_local, D) -> (B, S_local, D) through every layer, under the
    recompute policy ``remat`` ('none' | 'attn_out' | 'full'; it only
    matters while autograd records)."""
    if remat not in REMATS:
        raise ValueError(f"remat must be one of {REMATS}, got {remat!r}")

    def attn(p, x):
        return blocks.attention_block(rt, p, x, cfg, causal=causal,
                                      window=cfg.window,
                                      prefix_len=prefix_len)

    def mlp(p, x):
        return blocks.mlp_block(rt, p, x, cfg)

    def layer_fn(layer, x):
        return mlp(layer.mlp, attn(layer.mixer, x))

    if remat == "none" or not torch.is_grad_enabled():
        for layer in layers:
            x = layer_fn(layer, x)
    elif remat == "attn_out":
        for layer in layers:
            x = checkpoint(attn, layer.mixer, x, use_reentrant=False)
            x = checkpoint(mlp, layer.mlp, x, use_reentrant=False)
    else:
        for layer in layers:
            x = checkpoint(layer_fn, layer, x, use_reentrant=False)
    return x


def lm_loss(rt, params, batch, cfg: ModelConfig, *,
            remat: str = "attn_out"):
    """batch: {tokens, labels} (this rank's sequence slice); params: the
    rank's parameter tree (``factory.shard_params``). Returns the scalar
    mean loss."""
    if cfg.frontend_stub is not None:
        raise NotImplementedError(
            f"{cfg.name}: frontend embeddings (VLM / audio prefix) are not "
            "ported to repro_torch yet (ROADMAP.md §A: remaining model "
            "families)")
    x = blocks.embed(rt, params.embed, batch["tokens"], cfg)
    x = apply_stack(rt, params.layers, x, cfg, causal=True, remat=remat)
    x = blocks.rmsnorm(params.final_norm, x, cfg.norm_eps)
    return blocks.lm_head_logits_and_loss(rt, params.head, x,
                                          batch["labels"], cfg)
