"""minitron-8b [dense]: width/depth-pruned Nemotron-4.

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000 [arXiv:2407.14679; hf]
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=192, vocab_size=512, param_dtype="float32")
