"""xlstm-1.3b [ssm]: sLSTM + mLSTM blocks (no attention, no FFN: d_ff=0).

48L d_model=2048 4H (GQA kv=4) d_ff=0 vocab=50304 [arXiv:2405.04517; unverified]

No attention, so the StarTrail K/V ring does not apply: the mLSTM's matrix
memory runs as a chunked gated linear recurrence on each rank, corrected
across ranks by one gather of the ranks' final states
(``models.ssm.cross_shard_correction``). The sLSTM (1 block in 8) keeps
shard-local state during training and prefill (the JAX package's
documented approximation); decode is exact (step recurrent).
"""

import dataclasses

from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    xlstm=XLSTMConfig(slstm_every=8),
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
        vocab_size=256, xlstm=XLSTMConfig(slstm_every=2, chunk=8),
        param_dtype="float32")
