"""Architecture registry of the port: ``--arch <id>`` resolution, and the
paper's own models (``paper_model``).

Only ported architectures are listed: the dense all-attention ones, the
MoE family (phi3.5-moe, llama4-maverick), xLSTM (xlstm-1.3b), the
hybrid Mamba/attention/MoE stack (jamba-1.5-large), the encoder-decoder
seamless-m4t-large-v2 and the VLM prefix-LM paligemma-3b: every
architecture of the JAX reference.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

_ARCH_MODULES: Dict[str, str] = {
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "minitron-8b": "repro_torch.configs.minitron_8b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi3_5_moe_42b_a6_6b",
    "llama4-maverick-400b-a17b":
        "repro_torch.configs.llama4_maverick_400b_a17b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "paligemma-3b": "repro_torch.configs.paligemma_3b",
}

PORTED_ARCHS: List[str] = list(_ARCH_MODULES)
# the JAX registry's order (``launch.dryrun --all`` runs them in it)
ASSIGNED_ARCHS: List[str] = [
    "h2o-danube-1.8b", "minitron-8b", "deepseek-7b", "stablelm-3b",
    "paligemma-3b", "seamless-m4t-large-v2", "llama4-maverick-400b-a17b",
    "phi3.5-moe-42b-a6.6b", "xlstm-1.3b", "jamba-1.5-large-398b"]


def _module(name: str):
    if name in _ARCH_MODULES:
        return importlib.import_module(_ARCH_MODULES[name])
    raise KeyError(f"unknown arch {name!r}; ported: {PORTED_ARCHS}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).smoke_config()


def paper_model(name: str) -> ModelConfig:
    """The paper's GPT-3B, GPT-7B or DiT-1B (``configs.paper_models``)."""
    from repro_torch.configs import paper_models

    return {"gpt-3b": paper_models.GPT_3B, "gpt-7b": paper_models.GPT_7B,
            "dit-1b": paper_models.DIT_1B}[name]


def shape_supported(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(supported, reason). long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k":
        subq = cfg.window is not None or cfg.family in ("ssm", "hybrid")
        if not subq:
            return False, (
                "long_500k skipped: pure full-attention arch (no SWA/SSM); "
                "see DESIGN.md §Arch-applicability")
    return True, ""


def cells(archs=None) -> List[Tuple[str, str, bool, str]]:
    """All (arch, shape, supported, reason) assignment cells."""
    out = []
    for a in archs or ASSIGNED_ARCHS:
        cfg = get(a)
        for s in SHAPES.values():
            ok, why = shape_supported(cfg, s)
            out.append((a, s.name, ok, why))
    return out
