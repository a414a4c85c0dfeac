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

    The JAX fields this port does not read are left out: ``unroll_scans``
    (no XLA cost analysis) and the optimizer scalars, which live in
    ``optim.adamw.AdamWConfig``. ``sharding_rules`` names the rule set of
    ``dist.sharding`` each rank stores its parameter shards under;
    ``pipeline_scan`` the ring's issue order (``core.startrail``).
    """
    c: int = 1                           # StarTrail attention-parallel size
    # 'startrail' | 'ring' (C=1 startrail) | 'ulysses'
    attention_scheme: str = "startrail"
    # gradient-accumulation microbatches per optimizer step (train only)
    microbatches: int = 1
    seq_scheme: str = "zigzag"
    block_impl: str = "cuda"             # ring-step block kernel: 'ref'|'cuda'
    kernel_impl: str = "cuda"            # serving decode kernel: 'ref'|'cuda'
    block_skip: bool = False
    multi_pod: bool = False
    # recompute policy: 'none' | 'attn_out' | 'full' (models/transformer.py)
    remat: str = "attn_out"
    # gradient compression: 'none' | 'int8' (optim/grad.py, applied by the
    # train step)
    grad_compression: str = "none"
    # the ring's pipelined issue order: each transfer before the block
    # kernel that does not need it (core/startrail.py); no value changes
    pipeline_scan: bool = True
    # the ring's transfer sub-chunks (core/startrail.py); no value changes
    comm_chunks: int = 1
    # 'default' | 'fsdp' | 'tp' (dist/sharding.py)
    sharding_rules: str = "default"


def model_flops_per_token(cfg: ModelConfig) -> float:
    """Approx. 6*N_active params-FLOPs per token (for the roofline's
    MODEL_FLOPS = 6*N*D term). Embedding params excluded (standard)."""
    d, L = cfg.d_model, cfg.num_layers
    hd = cfg.head_dim_
    n = 0.0
    for i in range(L):
        mixer = cfg.mixer_on_layer(i)
        if mixer == "attn":
            n += d * hd * (cfg.num_heads + 2 * cfg.num_kv_heads)  # qkv
            n += cfg.num_heads * hd * d                           # out
        elif mixer == "mamba":
            m = cfg.mamba or MambaConfig()
            di = m.expand * d
            n += d * 2 * di + di * d + di * (2 * m.d_state + di // m.head_dim)
        elif mixer in ("mlstm", "slstm"):
            di = 2 * d
            n += d * di * 4 + di * d
        if cfg.moe_on_layer(i):
            n += cfg.moe.top_k * 3 * d * cfg.moe.d_ff_expert
            if cfg.moe.shared_expert:
                n += 3 * d * cfg.moe.d_ff_expert
        elif cfg.d_ff > 0 and mixer in ("attn", "mamba"):
            n += 3 * d * cfg.d_ff
    if cfg.encdec:
        for _ in range(cfg.num_encoder_layers):
            n += (d * hd * (cfg.num_heads + 2 * cfg.num_kv_heads)
                  + cfg.num_heads * hd * d)
            n += 3 * d * cfg.d_ff
            # the decoder's cross-attention, counted with the encoder's
            n += (d * hd * (cfg.num_heads + 2 * cfg.num_kv_heads)
                  + cfg.num_heads * hd * d)
    return 6.0 * n


def total_params(cfg: ModelConfig) -> float:
    """Approximate total parameter count (for memory accounting)."""
    d, L = cfg.d_model, cfg.num_layers
    hd = cfg.head_dim_
    n = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    for i in range(L):
        mixer = cfg.mixer_on_layer(i)
        if mixer == "attn":
            n += (d * hd * (cfg.num_heads + 2 * cfg.num_kv_heads)
                  + cfg.num_heads * hd * d)
        elif mixer == "mamba":
            m = cfg.mamba or MambaConfig()
            di = m.expand * d
            n += d * 2 * di + di * d + di * (2 * m.d_state + di // m.head_dim)
        elif mixer in ("mlstm", "slstm"):
            di = 2 * d
            n += d * di * 4 + di * d
        if cfg.moe_on_layer(i):
            n += cfg.moe.num_experts * 3 * d * cfg.moe.d_ff_expert
            if cfg.moe.shared_expert:
                n += 3 * d * cfg.moe.d_ff_expert
        elif cfg.d_ff > 0 and mixer in ("attn", "mamba"):
            n += 3 * d * cfg.d_ff
    if cfg.encdec:
        n += cfg.num_encoder_layers * (
            d * hd * (cfg.num_heads + 2 * cfg.num_kv_heads)
            + cfg.num_heads * hd * d + 3 * d * cfg.d_ff)
        n += cfg.num_layers * (  # cross-attention blocks
            d * hd * (cfg.num_heads + 2 * cfg.num_kv_heads)
            + cfg.num_heads * hd * d)
    return float(n)
