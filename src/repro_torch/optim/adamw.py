"""AdamW (the port's counterpart of ``repro.optim.adamw``), as plain
functions on lists of tensors.

``apply`` mirrors the JAX ``upd`` op for op: every leaf's arithmetic runs
in float32 and is cast once to the parameter dtype (and the state dtype).
``torch.optim.AdamW`` is not used: it would update bf16 parameters in bf16
and order the decay differently. The update is written into the parameter
and moment tensors in place, which saves holding a second copy of them
(15 GB of f32 moments at full width); ``apply`` returns them for the JAX
call shape. Under sharded storage (``train.step``) on a ``ThreadMesh`` the
step runs it over each unique parameter shard once: ``state_partition``
gives the moments of those shards, views of the moment tensors, the
counterpart of the JAX ``state_partition`` (moments shard-local), and
``global_norm`` over the unique shards is the norm of the whole gradients.
A rank process holds shard-sized moments of its own shards
(``init_state`` of them) and passes ``apply`` the norm its mesh agreed on
(``square_sums`` of its owned shards, summed over the mesh by
``train.step``, then ``norm_of``). The step counter is a
host integer and the scalars derived
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


def state_partition(state: Dict, index: Sequence[Tuple[int, Tuple]]
                    ) -> Dict:
    """The state of the parameter shards ``index`` ((leaf, block) pairs,
    as ``dist.sharding.shard_slices`` gives blocks): each moment a view of
    its leaf's block, so ``apply`` writes the leaf's moments in place."""
    return {"mu": [state["mu"][i][sl] for i, sl in index],
            "nu": [state["nu"][i][sl] for i, sl in index],
            "step": state["step"]}


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


def square_sums(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each gradient's sum of squares, in f32."""
    return [torch.sum(torch.square(g.float())) for g in grads]


def norm_of(sums: Sequence[torch.Tensor]) -> torch.Tensor:
    """The l2 norm whose squared parts are ``sums``, added in order."""
    return torch.sqrt(torch.sum(torch.stack(list(sums))))


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """The l2 norm over every element of ``grads`` (whole leaves, or the
    unique shards of them: each element counted once)."""
    return norm_of(square_sums(grads))


@torch.no_grad()
def apply(params: List[torch.Tensor], grads: Sequence[torch.Tensor],
          state: Dict, cfg: AdamWConfig,
          gnorm: Optional[torch.Tensor] = None
          ) -> Tuple[List[torch.Tensor], Dict, Dict[str, torch.Tensor]]:
    """One AdamW step, in place. Returns (params, state, metrics).
    ``gnorm`` is the norm of the whole gradients where ``grads`` are not
    all of them (a rank process's shards; default: ``global_norm``)."""
    step = state["step"] + 1
    lr = schedule(step, cfg)
    if gnorm is None:
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
