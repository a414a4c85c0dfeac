"""Decoder LM assembly (the port's counterpart of ``repro.models.transformer``).

The JAX package scans a repeating *period* of sub-layers over stacked
parameters; PyTorch runs eagerly, so the port keeps one module per layer
(``layers[i].mixer`` / ``layers[i].mlp``) and loops. Only dense,
all-attention stacks are ported (the serving slice); MoE, hybrid and SSM
periods raise, naming the ROADMAP queue.
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
