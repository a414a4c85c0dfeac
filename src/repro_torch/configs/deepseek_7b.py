"""deepseek-7b [dense]: llama-architecture (MHA: kv == heads).

30L d_model=4096 32H (GQA kv=32) d_ff=11008 vocab=102400 [arXiv:2401.02954; hf]
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=176, vocab_size=512, param_dtype="float32")
