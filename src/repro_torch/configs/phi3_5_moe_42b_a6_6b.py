"""phi3.5-moe-42b-a6.6b [moe]: 16 experts, top-2, MoE on every layer.

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16e top-2
[hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""

import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=6400,
                  every_n_layers=1),
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128,
                      every_n_layers=1),
        param_dtype="float32")
