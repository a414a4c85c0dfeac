"""Config system: model architecture.

The port's own copy of the model half of ``repro.configs.base`` (the JAX
package's module is jax-free, but the port imports nothing of ``repro``);
the shape and run configs join when the training slice needs them. Every ported
architecture gets a ``src/repro_torch/configs/<id>.py`` exporting ``CONFIG``
(exact published sizes) and ``smoke_config()`` (reduced same-family config
for CPU tests). ``registry.get(name)`` resolves both.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    every_n_layers: int = 1      # MoE replaces the MLP on every n-th layer
    shared_expert: bool = False  # Llama-4 style shared expert alongside routed
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2              # d_inner = expand * d_model
    head_dim: int = 64           # SSD head size
    chunk: int = 64              # intra-chunk SSD block length


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8         # 1 sLSTM per this many blocks (rest mLSTM)
    chunk: int = 64


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None       # default d_model // num_heads
    window: Optional[int] = None         # sliding-window attention (tokens)
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    attn_every: int = 1          # hybrid: attention on every n-th mixer layer
    encdec: bool = False
    num_encoder_layers: int = 0
    prefix_len_frac: float = 0.0  # vlm: fraction of sequence that is a
                                  # bidirectional prefix (image patches)
    frontend_stub: Optional[str] = None  # 'patch' (vlm) | 'frames' (audio)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    # optimizer-state dtype: fp32 default; bf16 for the >=398B archs so a
    # single 256-chip v5e pod fits (recorded in EXPERIMENTS.md §Dry-run)
    opt_dtype: str = "float32"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def moe_on_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        n = self.moe.every_n_layers
        # MoE on the last layer of each n-block (Llama-4 interleave style)
        return (i % n) == (n - 1)

    def mixer_on_layer(self, i: int) -> str:
        """'attn' | 'mamba' | 'mlstm' | 'slstm' for decoder layer i."""
        if self.family == "ssm" and self.xlstm is not None:
            return "slstm" if (i % self.xlstm.slstm_every) == (self.xlstm.slstm_every - 1) else "mlstm"
        if self.family == "hybrid":
            # Jamba: attention on one of every `attn_every` layers
            return "attn" if (i % self.attn_every) == (self.attn_every // 2) else "mamba"
        return "attn"
