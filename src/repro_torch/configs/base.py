"""Config system: model architecture, run shapes, parallelism + training.

The port's own copy of ``repro.configs.base`` (the JAX package's module is
jax-free, but the port imports nothing of ``repro``). Every ported
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


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str            # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str            # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Parallelism + training hyper-config for one run, normally produced by
    ``repro_torch.plan.ExecutionPlan.run_config()``.

    The JAX fields this port does not read yet are left out: the sharding
    rules (parameters are stored whole), ``unroll_scans`` (no XLA cost
    analysis), ``pipeline_scan`` / ``comm_chunks`` (they reorder or split
    ring transfers without changing a value; ROADMAP.md §A) and the
    optimizer scalars, which live in ``optim.adamw.AdamWConfig``.
    """
    c: int = 1                           # StarTrail attention-parallel size
    # 'startrail' | 'ring' (C=1 startrail); 'ulysses' is not ported
    attention_scheme: str = "startrail"
    # gradient-accumulation microbatches per optimizer step (train only)
    microbatches: int = 1
    seq_scheme: str = "zigzag"
    block_impl: str = "cuda"             # ring-step block kernel: 'ref'|'cuda'
    kernel_impl: str = "cuda"            # serving decode kernel: 'ref'|'cuda'
    block_skip: bool = False
    multi_pod: bool = False
    # 'none' is the only policy ported ('attn_out' / 'full' recompute
    # changes no value; ROADMAP.md §A)
    remat: str = "none"
    # cross-pod gradient compression ('none'; 'int8' is not ported)
    grad_compression: str = "none"
