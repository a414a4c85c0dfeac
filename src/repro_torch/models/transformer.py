"""Decoder LM assembly (the port's counterpart of ``repro.models.transformer``).

The JAX package scans a repeating *period* of sub-layers over stacked
parameters; PyTorch runs eagerly, so the port keeps one module per layer
(``layers[i].mixer`` / ``layers[i].mlp``) and loops, layer ``i`` taking
sub-layer ``i % len(period)`` of ``layer_pattern``. Dense stacks have a
period of one (attention, MLP); MoE stacks a period of
``moe.every_n_layers`` with the MoE block (``models.moe``, stored under
``mlp`` as in the JAX tree) on its last layer and a dense MLP on the others
(llama4-maverick: dense, then MoE). Hybrid, SSM and encoder-decoder periods
raise, naming the ROADMAP queue.

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
each MoE block with its all-to-alls, runs twice per step. 'full' keeps
only the layer input (one region around the layer); 'none' keeps every
activation. Recompute changes no value.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks, moe

REMATS = ("none", "attn_out", "full")
# the aux-loss weights of a MoE layer (JAX ``apply_stack``)
LB_WEIGHT, Z_WEIGHT = 0.01, 1e-3


def layer_pattern(cfg: ModelConfig) -> List[Tuple[str, Optional[str]]]:
    """The repeating (mixer, mlp) period of the architecture: (attn, mlp)
    for a dense stack; for a MoE stack ``every_n_layers`` attention layers
    with 'moe' on the last."""
    if (cfg.family not in ("dense", "moe") or cfg.encdec
            or (cfg.d_ff == 0 and cfg.moe is None)):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (hybrid / SSM / "
            "encoder-decoder layers) is not ported to repro_torch yet "
            "(ROADMAP.md §A8 b-d: remaining model families)")
    period = cfg.moe.every_n_layers if cfg.moe is not None else 1
    if cfg.num_layers % period:
        raise ValueError(f"{cfg.num_layers=} not divisible by {period=}")
    return [("attn", "moe" if cfg.moe_on_layer(i) else "mlp")
            for i in range(period)]


def has_moe(cfg: ModelConfig) -> bool:
    return any(mlp == "moe" for _, mlp in layer_pattern(cfg))


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """Each layer's MLP kind, 'mlp' or 'moe', in stack order."""
    pat = layer_pattern(cfg)
    return [pat[i % len(pat)][1] for i in range(cfg.num_layers)]


def lm_specs(cfg: ModelConfig):
    s = {
        "embed": blocks.embedding_specs(cfg),
        "layers": [{"mixer": blocks.attention_specs(cfg),
                    "mlp": (moe.moe_specs(cfg) if kind == "moe"
                            else blocks.mlp_specs(cfg))}
                   for kind in layer_kinds(cfg)],
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
    kinds = layer_kinds(cfg)

    def attn(p, x):
        return blocks.attention_block(rt, p, x, cfg, causal=causal,
                                      window=cfg.window,
                                      prefix_len=prefix_len)

    def layer_fn(layer, x, kind):
        return mlp_sublayer(rt, layer.mlp, attn(layer.mixer, x), cfg, kind)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer, kind in zip(layers, kinds):
        if remat == "none" or not torch.is_grad_enabled():
            x, a = layer_fn(layer, x, kind)
        elif remat == "attn_out":
            x = checkpoint(attn, layer.mixer, x, use_reentrant=False)
            x, a = checkpoint(mlp_sublayer, rt, layer.mlp, x, cfg, kind,
                              use_reentrant=False)
        else:
            x, a = checkpoint(layer_fn, layer, x, kind, use_reentrant=False)
        if a is not None:
            aux = aux + a
    return x, aux


def lm_loss(rt, params, batch, cfg: ModelConfig, *,
            remat: str = "attn_out"):
    """batch: {tokens, labels} (this rank's sequence slice); params: the
    rank's parameter tree (``factory.shard_params``). Returns the scalar
    mean loss plus the MoE layers' auxiliary losses."""
    if cfg.frontend_stub is not None:
        raise NotImplementedError(
            f"{cfg.name}: frontend embeddings (VLM / audio prefix) are not "
            "ported to repro_torch yet (ROADMAP.md §A: remaining model "
            "families)")
    x = blocks.embed(rt, params.embed, batch["tokens"], cfg)
    x, aux = apply_stack(rt, params.layers, x, cfg, causal=True,
                         remat=remat)
    x = blocks.rmsnorm(params.final_norm, x, cfg.norm_eps)
    return blocks.lm_head_logits_and_loss(rt, params.head, x,
                                          batch["labels"], cfg) + aux
