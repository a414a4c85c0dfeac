"""llama4-maverick-400b-a17b [moe]: 128-expert top-1 MoE with shared expert.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Per the public Llama-4 architecture, MoE layers interleave with dense
layers (interleave_moe_layer_step = 2), which is also what makes the
"400b total / 17b active" label consistent: 24 MoE layers x 128 experts x
3*5120*8192 ~ 386B routed params + dense/attention ~ 400B total, with
top-1 + shared expert ~ 17B active. Optimizer state is kept in bf16 so a
single 256-chip v5e pod (4 TB HBM) fits; fp32 state needs the 2-pod mesh.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    moe=MoEConfig(num_experts=128, top_k=1, d_ff_expert=8192,
                  every_n_layers=2, shared_expert=True),
    opt_dtype="bfloat16",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=1, d_ff_expert=128,
                      every_n_layers=2, shared_expert=True),
        param_dtype="float32", opt_dtype="float32")
