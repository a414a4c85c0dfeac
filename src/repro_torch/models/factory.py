"""Model factory: config -> parameters (the port's counterpart of
``repro.models.factory``).

``build_model(cfg, device, seed)`` makes a ``Model`` whose parameters are
drawn from a seeded ``torch.Generator`` on ``device`` with the JAX
package's per-leaf scales. ``from_jax_params(tree, cfg, device)`` carries a
JAX parameter tree (numpy arrays, as ``np.asarray`` of
``repro.models.factory.Model.init``) across: the leading period dimension
of ``tree["stack"]`` is un-stacked into per-layer modules and every leaf
keeps its einsum layout, so both packages compute the same products.
``to_jax_layout(named, cfg)`` is its inverse: per-layer tensors keyed by
their ``named_parameters`` names (parameters, or their gradients) are
restacked into the JAX tree, so tests compare the two leaf by leaf.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import spec, transformer


class Model(nn.Module):
    """Decoder LM parameters: ``embed.table``, ``layers[i].mixer`` (wq, wk,
    wv, wo, norm), ``layers[i].mlp`` (w1, w3, w2, norm), ``final_norm``,
    ``lm_head.table``. The serving forward passes live in ``serve.step``;
    the training loss is ``loss``."""

    def __init__(self, cfg: ModelConfig, make):
        super().__init__()
        self.cfg = cfg
        root = spec.build_module(transformer.lm_specs(cfg), make)
        for name, child in root.named_children():
            self.add_module(name, child)

    @property
    def head(self) -> nn.Module:
        return self.lm_head if hasattr(self, "lm_head") else self.embed

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def param_count(self) -> int:
        return spec.count_params(self)

    def loss(self, rt, batch, *, remat: str = "none"):
        """The training loss of ``batch`` ({tokens, labels}, this rank's
        slice) under the runtime ``rt``."""
        return transformer.lm_loss(rt, self, batch, self.cfg, remat=remat)


def build_model(cfg: ModelConfig, device="cpu", seed: int = 0) -> Model:
    """A model with weights drawn from ``torch.Generator(device)`` seeded
    with ``seed`` (normal, fan-in scaled; norms ones)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    with torch.no_grad():
        return Model(cfg, lambda s: spec.init_leaf(s, gen, cfg.param_dtype,
                                                   device))


def from_jax_params(tree, cfg: ModelConfig, device="cpu") -> Model:
    """The port's ``Model`` holding the JAX package's parameters ``tree``."""
    pat = transformer.layer_pattern(cfg)
    stack = tree["stack"]
    n_periods = np.asarray(stack["sub0"]["mixer"]["wq"]).shape[0]
    if n_periods * len(pat) != cfg.num_layers:
        raise ValueError(f"tree has {n_periods} periods of {len(pat)} "
                         f"layers, config has {cfg.num_layers}")
    flat = {"embed": tree["embed"], "final_norm": tree["final_norm"],
            "layers": [{"mixer": stack[f"sub{i % len(pat)}"]["mixer"],
                        "mlp": stack[f"sub{i % len(pat)}"]["mlp"],
                        "_period": i // len(pat)}
                       for i in range(cfg.num_layers)]}
    if "lm_head" in tree:
        flat["lm_head"] = tree["lm_head"]
    model = Model(cfg, lambda s: torch.empty(
        s.shape, dtype=spec.DTYPES[s.dtype or cfg.param_dtype],
        device=device))

    def fill(mod: nn.Module, src, period: Optional[int]):
        for name, param in mod.named_parameters(recurse=False):
            arr = np.asarray(src[name])
            if period is not None:
                arr = arr[period]
            if tuple(arr.shape) != tuple(param.shape):
                raise ValueError(f"{name}: JAX leaf {arr.shape} vs port "
                                 f"{tuple(param.shape)}")
            param.data.copy_(torch.from_numpy(np.array(arr, np.float32)))
        for name, child in mod.named_children():
            if isinstance(child, nn.ModuleList):
                for i, layer in enumerate(child):
                    fill(layer, src[name][i], src[name][i]["_period"])
            else:
                fill(child, src[name], period)

    with torch.no_grad():
        fill(model, flat, None)
    return model


def to_jax_layout(named: Mapping[str, torch.Tensor], cfg: ModelConfig
                  ) -> Dict:
    """The JAX parameter tree (nested dicts of f32 numpy arrays) holding
    ``named``, a map from the port's parameter names (``layers.3.mixer.wq``,
    as ``Model.named_parameters`` gives them) to tensors of those shapes:
    the per-layer leaves are stacked along the JAX stack's leading period
    dimension. The inverse of ``from_jax_params``."""
    pat = transformer.layer_pattern(cfg)
    tree: Dict = {}
    layers: Dict[int, Dict] = {}
    for name, t in named.items():
        arr = t.detach().float().cpu().numpy()
        parts = name.split(".")
        if parts[0] == "layers":
            node = layers.setdefault(int(parts[1]), {})
            parts = parts[2:]
        else:
            node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = arr
    if len(layers) != cfg.num_layers:
        raise ValueError(f"{len(layers)} layers named, config has "
                         f"{cfg.num_layers}")

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    tree["stack"] = {
        f"sub{i}": stack([layers[j] for j in range(i, cfg.num_layers,
                                                   len(pat))])
        for i in range(len(pat))}
    return tree
