"""The kernels' meta rules: what each hand-written kernel does to a trace
on the meta device (``launch.dryrun``), which launches nothing.

A kernel wrapper given meta tensors (``kernels.dispatch`` under
``impl='cuda'``) runs the same checks as before a launch, so it raises
wherever the kernel raises (a head size the kernel does not take, a
dtype or a shape it refuses), allocates the kernel's outputs (their
shapes and dtypes), and instead of launching calls ``charge`` with the
kernel's own FLOPs and bytes:

  FLOPs  4 * D per (query, key) pair and query head forward (B1, B2, B4,
         B5, B6: the scores and P @ V), 10 * D backward (B3, B7: the
         recomputed scores, dP, dQ, dK, dV); the formulas of the bounds
         in ``chip_smoke.py`` (PERF.md). Positions on the meta device
         carry no values, so every pair of the tile is charged: the
         count of the plain version on an unmasked tile, and an upper
         bound where a mask lets the kernel skip tiles.
  bytes  every input read once and every output written once (B4 and
         B6: the K and V of the table's ``W * page_size`` slots per row,
         not the whole pool).

The plain version's (Sq x Sk) intermediates never enter such a trace.
``charging(sink)`` routes the charges to ``sink(name, flops, nbytes)``
for the duration of a trace; outside one they go nowhere. The kernels'
``LAUNCHES`` counters do not move.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List

_SINKS: List[Callable] = []


@contextlib.contextmanager
def charging(sink: Callable):
    """Send every meta rule's charge to ``sink(name, flops, nbytes)``."""
    _SINKS.append(sink)
    try:
        yield sink
    finally:
        _SINKS.remove(sink)


def io_bytes(*tensors) -> int:
    """Bytes of ``tensors`` (None entries skipped), each counted once."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def charge(name: str, flops: float, nbytes: int, outputs):
    """Record one meta launch of kernel ``name``; returns ``outputs``."""
    for sink in _SINKS:
        sink(name, float(flops), int(nbytes))
    return outputs


def attention_flops(q, sk: int, per_pair: int = 4) -> float:
    """``per_pair * D`` FLOPs for every (query, key) pair and query head of
    q (B, Sq, Hq, D) against ``sk`` keys."""
    B, Sq, Hq, D = q.shape
    return float(per_pair) * D * Hq * B * Sq * sk
