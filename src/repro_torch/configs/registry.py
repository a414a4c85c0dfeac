"""Architecture registry of the port: ``--arch <id>`` resolution.

Only ported architectures are listed. Any other architecture of the JAX
package raises, naming the ROADMAP queue that ports it.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES: Dict[str, str] = {
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
}

# architectures of the JAX reference not yet ported (ROADMAP.md §A,
# "Remaining model families", ports them)
_UNPORTED = (
    "minitron-8b", "deepseek-7b", "stablelm-3b", "paligemma-3b",
    "seamless-m4t-large-v2", "llama4-maverick-400b-a17b",
    "phi3.5-moe-42b-a6.6b", "xlstm-1.3b", "jamba-1.5-large-398b",
)

PORTED_ARCHS: List[str] = list(_ARCH_MODULES)


def _module(name: str):
    if name in _ARCH_MODULES:
        return importlib.import_module(_ARCH_MODULES[name])
    if name in _UNPORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to repro_torch yet (ROADMAP.md "
            f"§A: remaining model families); ported: {PORTED_ARCHS}")
    raise KeyError(f"unknown arch {name!r}; ported: {PORTED_ARCHS}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).smoke_config()
