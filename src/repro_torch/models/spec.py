"""Spec-first parameter trees (the port's counterpart of ``repro.models.spec``).

Blocks declare their parameters once as ``PSpec`` leaves (shape + logical
axis names + initialiser), in the JAX package's einsum layouts. The same tree
then yields the ``nn.Module`` that holds the parameters (``build_module``),
initialised from a seeded ``torch.Generator`` with the JAX package's per-leaf
scales: normal with stddev ``scale`` or ``fan_in ** -0.5`` (fan-in = the
first dim), or zeros / ones. The two frameworks draw different numbers from
the same seed; tests share weights through ``factory.from_jax_params``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
from torch import nn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class PSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]       # logical axis name per dim
    init: str = "normal"                  # normal | zeros | ones
    scale: Optional[float] = None         # stddev; default fan-in
    dtype: Optional[str] = None           # override model param_dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def init_leaf(spec: PSpec, gen: torch.Generator, default_dtype: str,
              device) -> torch.Tensor:
    dtype = DTYPES[spec.dtype or default_dtype]
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    fan_in = spec.shape[0] if spec.shape else 1
    scale = spec.scale if spec.scale is not None else fan_in ** -0.5
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (x * scale).to(dtype)


def build_module(tree, make: Callable[[PSpec], torch.Tensor]) -> nn.Module:
    """An ``nn.Module`` mirroring ``tree``: dicts become submodules, lists
    ``nn.ModuleList``s, and each ``PSpec`` a frozen ``nn.Parameter`` made by
    ``make`` (leaves are visited in sorted-key order)."""
    mod = nn.Module()
    for name in sorted(tree):
        sub = tree[name]
        if isinstance(sub, PSpec):
            mod.register_parameter(
                name, nn.Parameter(make(sub), requires_grad=False))
        elif isinstance(sub, list):
            mod.add_module(name, nn.ModuleList(
                [build_module(s, make) for s in sub]))
        else:
            mod.add_module(name, build_module(sub, make))
    return mod


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
