"""seamless-m4t-large-v2 [audio]: encoder-decoder, multimodal.

24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206 [arXiv:2308.11596; hf]

The speech frontend (w2v-BERT feature extractor) is a stub: the batch
carries precomputed frame embeddings (``frontend_emb``) for the encoder.
24 encoder + 24 decoder layers (``models.encdec``); decoder self-attention
is causal StarTrail, encoder self-attention is full-mask StarTrail,
cross-attention uses the (static) team-gathered encoder K/V.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,
    num_encoder_layers=24,
    encdec=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    frontend_stub="frames",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, num_encoder_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, d_ff=128, vocab_size=512, param_dtype="float32")
