"""AdamW (the port's counterpart of ``repro.optim.adamw``), as plain
functions on lists of tensors.

``apply`` mirrors the JAX ``upd`` op for op: every leaf's arithmetic runs
in float32 and is cast once to the parameter dtype (and the state dtype).
``torch.optim.AdamW`` is not used: it would update bf16 parameters in bf16
and order the decay differently. The update is written into the parameter
and moment tensors in place, which saves holding a second copy of them
(15 GB of f32 moments at full width); ``apply`` returns them for the JAX
call shape. The step counter is a host integer and the scalars derived
from it are float32 CPU tensors, so a step reads nothing back from the
device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.models.spec import DTYPES


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0
    state_dtype: str = "float32"
    warmup_steps: int = 100
    decay_steps: int = 10000
    min_lr_ratio: float = 0.1


def init_state(params: Sequence[torch.Tensor], cfg: AdamWConfig) -> Dict:
    dt = DTYPES[cfg.state_dtype]
    return {
        "mu": [torch.zeros(p.shape, dtype=dt, device=p.device)
               for p in params],
        "nu": [torch.zeros(p.shape, dtype=dt, device=p.device)
               for p in params],
        "step": 0,
    }


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def schedule(step: int, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio (f32, on the CPU)."""
    s = _f32(step)
    warm = torch.minimum(s / max(cfg.warmup_steps, 1), _f32(1.0))
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.learning_rate * warm * cos


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    leaves = [torch.sum(torch.square(g.float())) for g in grads]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def apply(params: List[torch.Tensor], grads: Sequence[torch.Tensor],
          state: Dict, cfg: AdamWConfig
          ) -> Tuple[List[torch.Tensor], Dict, Dict[str, torch.Tensor]]:
    """One AdamW step, in place. Returns (params, state, metrics)."""
    step = state["step"] + 1
    lr = schedule(step, cfg)
    gnorm = global_norm(grads)
    scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    if cfg.grad_clip is not None:
        scale = torch.minimum(scale, cfg.grad_clip / gnorm.clamp_min(1e-9))

    b1, b2 = cfg.b1, cfg.b2
    sf = _f32(step)
    bc1 = 1 - _f32(b1) ** sf
    bc2 = 1 - _f32(b2) ** sf
    sdt = DTYPES[cfg.state_dtype]

    for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
        g = g.float() * scale
        mu32 = mu.float() * b1 + (1 - b1) * g
        nu32 = nu.float() * b2 + (1 - b2) * g * g
        mhat = mu32 / bc1
        vhat = nu32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        mu.copy_(mu32.to(sdt))
        nu.copy_(nu32.to(sdt))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
