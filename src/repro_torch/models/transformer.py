"""Decoder LM assembly (the port's counterpart of ``repro.models.transformer``).

The JAX package scans a repeating *period* of sub-layers over stacked
parameters; PyTorch runs eagerly, so the port keeps one module per layer
(``layers[i].mixer`` / ``layers[i].mlp``) and loops. Only dense,
all-attention stacks are ported; MoE, hybrid and SSM periods raise, naming
the ROADMAP queue. Recompute (the JAX ``remat`` policies 'attn_out' and
'full') is not ported: it changes no value, and the full-width model fits
one card at seq 4096 without it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks


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
                prefix_len=None, remat: str = "none"):
    """x: (B, S_local, D) -> (B, S_local, D) through every layer."""
    if remat != "none":
        raise NotImplementedError(
            f"remat={remat!r}: recompute is not ported to repro_torch yet "
            "(ROADMAP.md §A); use remat='none'")
    for layer in layers:
        x = blocks.attention_block(rt, layer.mixer, x, cfg, causal=causal,
                                   window=cfg.window, prefix_len=prefix_len)
        x = blocks.mlp_block(rt, layer.mlp, x, cfg)
    return x


def lm_loss(rt, model, batch, cfg: ModelConfig, *, remat: str = "none"):
    """batch: {tokens, labels} (this rank's sequence slice). Returns the
    scalar mean loss."""
    if cfg.frontend_stub is not None:
        raise NotImplementedError(
            f"{cfg.name}: frontend embeddings (VLM / audio prefix) are not "
            "ported to repro_torch yet (ROADMAP.md §A: remaining model "
            "families)")
    x = blocks.embed(rt, model.embed, batch["tokens"], cfg)
    x = apply_stack(rt, model.layers, x, cfg, causal=True, remat=remat)
    x = blocks.rmsnorm(model.final_norm, x, cfg.norm_eps)
    return blocks.lm_head_logits_and_loss(rt, model.head, x,
                                          batch["labels"], cfg)
