"""The paper's own evaluation models (Table 3): GPT 3B / GPT 7B / DiT 1B
(the port's copy of ``repro.configs.paper_models``, field for field).

The planner reads all three; GPT-7B is the model of the paper's throughput
figures. ``ModelConfig`` has no attention-mask field, so DiT-1B runs, in
both packages, as a dense causal LM backbone of its sizes (no text or image
encoders). GPT-3B's head size 256 is one of every card kernel's head sizes
(``kernels/flash_attention.py:HEAD_DIMS``): it trains, and the paged engine
serves it (B4 and B6 at head size 256).
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

# note: the paper's GPT-3B row (12 heads, hidden 4096) is not head-divisible
# (4096/12 = 341.3); we keep 12 heads and use head_dim=256 like common 3B
# configs.
GPT_3B = ModelConfig(
    name="gpt-3b", family="dense", num_layers=16, d_model=4096,
    num_heads=12, num_kv_heads=12, d_ff=16384, vocab_size=50304,
    head_dim=256,
)

GPT_7B = ModelConfig(
    name="gpt-7b", family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=32, d_ff=16384, vocab_size=50304,
)

DIT_1B = ModelConfig(
    name="dit-1b", family="dense", num_layers=24, d_model=1536,
    num_heads=24, num_kv_heads=24, d_ff=6144, vocab_size=8,  # patch tokens
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        GPT_7B, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, param_dtype="float32")
