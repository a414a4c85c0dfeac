"""jamba-1.5-large-398b [hybrid]: Mamba + attention 1:7, MoE 16e top-2.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536 [arXiv:2403.19887; hf]

Layer pattern: one attention layer per 8 mixer layers (the rest Mamba,
``models.ssm.mamba_block``), MoE replacing the MLP on every other layer:
a period of lcm(8, 2) = 8 layers. The Mamba mixer runs its SSD form over
``chunked_gla`` and exchanges a causal-conv halo between SP ranks, so the
sequence is laid out contiguously. Optimizer state bf16 (398B params).
"""

import dataclasses

from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    attn_every=8,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576,
                  every_n_layers=2),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, head_dim=64),
    opt_dtype="bfloat16",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, attn_every=4,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128,
                      every_n_layers=2),
        mamba=MambaConfig(d_state=4, d_conv=4, expand=2, head_dim=16,
                          chunk=8),
        param_dtype="float32", opt_dtype="float32")
