"""ExecutionPlan: the resolved description of one serving run (the port's
counterpart of ``repro.plan.plan``, cut to the fields the engine reads).

``make_serve_plan`` needs an explicit StarTrail ``c``: the JAX package picks
it with the analytical cost model (``repro.plan.cost``), which is not
ported yet, so ``c=None`` raises (ROADMAP.md §A).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dispatch import IMPLS, resolve_impl


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Fully-resolved serving run. P_sp = n_devices / data; serving caches
    use the contiguous sequence layout."""

    arch: str
    seq_len: int                   # engine capacity (max prompt + budget)
    n_devices: int
    data: int = 1
    c: int = 1
    block_impl: str = "cuda"       # ring-step block kernel ('ref' | 'cuda')
    block_skip: bool = False
    decode_batch: int = 0          # engine decode slots (0 = not a serve plan)
    page_size: int = 0             # KV page tokens (0 = not a serve plan)
    kernel_impl: str = "cuda"      # paged-decode kernel ('ref' | 'cuda')
    prefix_cache: bool = False     # not ported: the engine raises
    host_tier_bytes: int = 0       # not ported: the engine raises

    @property
    def sp_size(self) -> int:
        return self.n_devices // self.data

    @property
    def r(self) -> int:
        return self.sp_size // (self.c * self.c)

    def __post_init__(self):
        if self.data < 1 or self.n_devices < 1 or self.n_devices % self.data:
            raise ValueError(f"n_devices={self.n_devices} not divisible by "
                             f"data={self.data}")
        sp = self.sp_size
        if self.c < 1 or sp % (self.c * self.c):
            raise ValueError(
                f"C={self.c} invalid for P={sp}: need P % C^2 == 0")
        if self.seq_len % sp:
            raise ValueError(
                f"seq_len={self.seq_len} not divisible by SP={sp}")
        for knob, val in (("block_impl", self.block_impl),
                          ("kernel_impl", self.kernel_impl)):
            if val not in IMPLS:
                raise ValueError(f"{knob} must be one of {IMPLS}, "
                                 f"got {val!r}")
        if self.decode_batch < 0 or self.page_size < 0:
            raise ValueError("decode_batch/page_size must be >= 0")
        if self.page_size and self.seq_len % self.page_size:
            raise ValueError(
                f"seq_len={self.seq_len} not divisible by "
                f"page_size={self.page_size}")


def make_serve_plan(cfg: ModelConfig, *, arch: Optional[str] = None,
                    n_devices: int = 1, data: int = 1,
                    c: Optional[int] = None, decode_batch: int = 4,
                    page_size: int = 8, max_len: int = 512,
                    kernel_impl: Optional[str] = None,
                    block_impl: Optional[str] = None,
                    prefix_cache: bool = False,
                    host_tier_bytes: int = 0) -> ExecutionPlan:
    """Resolve one serving run into a plan.

    ``seq_len`` is the engine capacity (``max_len`` rounded up so both the
    SP degree and the page size divide it). A sliding window turns
    ring-block skipping on, as in the JAX package's contiguous layout.
    """
    if c is None:
        raise NotImplementedError(
            "make_serve_plan(c=None) needs the analytical cost model "
            "(repro/plan/cost.py), not ported yet (ROADMAP.md §A): pass c")
    if n_devices % data:
        raise ValueError(f"n_devices={n_devices} not divisible by "
                         f"data={data}")
    if page_size < 1:
        raise ValueError("page_size must be >= 1")
    if decode_batch < 1:
        raise ValueError("decode_batch must be >= 1")
    quantum = math.lcm(n_devices // data, page_size)
    seq_len = ((max_len + quantum - 1) // quantum) * quantum
    return ExecutionPlan(
        arch=arch or cfg.name, seq_len=seq_len, n_devices=n_devices,
        data=data, c=c, block_impl=resolve_impl(block_impl),
        block_skip=cfg.window is not None, decode_batch=decode_batch,
        page_size=page_size, kernel_impl=resolve_impl(kernel_impl),
        prefix_cache=prefix_cache, host_tier_bytes=host_tier_bytes)
