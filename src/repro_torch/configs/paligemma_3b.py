"""paligemma-3b [vlm]: gemma-2b text backbone behind a SigLIP frontend.

18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216 [arXiv:2407.07726; hf]

The SigLIP vision tower is a stub: the batch carries precomputed patch
embeddings (``frontend_emb``) that take the place of the token embeddings
at the sequence's first ``int(prefix_len_frac * seq_len)`` positions and
form a bidirectional prefix (PaliGemma prefix-LM masking); text tokens
continue causally. One kv head (MQA) makes head-sharded SP (Ulysses)
impossible here, so the model always runs StarTrail. Head size 256.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    prefix_len_frac=0.125,   # image-patch prefix fraction of the sequence
    frontend_stub="patch",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
        head_dim=16, d_ff=192, vocab_size=512, param_dtype="float32")
