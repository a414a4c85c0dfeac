"""DeepSpeed-Ulysses baseline: all-to-all head-sharded sequence
parallelism (the port of ``repro.core.ulysses``).

The paper compares StarTrail against it (§2.2.1): its SP degree cannot
exceed the head counts, so a config whose kv heads do not divide by P
(``paligemma-3b``'s one kv head) cannot use it at all, where StarTrail has
no such limit. It raises a clear error in that case.

Per rank: three ``all_to_all`` collectives over the joint SP axes take q,
k and v from sequence-sharded to head-sharded (the sequence gathered in
linear SP-rank order, the heads split contiguously, so every kv head stays
with its query heads); one full-sequence attention over the whole sequence
(``kernels.ops.flash_attention``: B1 forward, B3 backward on 'cuda'); one
``all_to_all`` back. The all-to-alls are autograd Functions on a
``ThreadMesh``, so the scheme trains.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.startrail import StarTrailConfig, shard_positions
from repro_torch.kernels import ops


@functools.lru_cache(maxsize=16)
def sequence_positions(seq_len: int, sp: int, scheme: str,
                       device: torch.device) -> torch.Tensor:
    """The whole sequence's positions in shard-major order of ``scheme``
    on ``device``, built once per (seq_len, sp, scheme, device) and shared
    by every layer, rank and pass (callers only read it)."""
    return torch.cat([shard_positions(r, seq_len, sp, scheme)
                      for r in range(sp)]).to(device)


def ulysses_attention(q, k, v, cfg: StarTrailConfig, comm):
    """Per-rank Ulysses attention over ``cfg.axes`` of ``comm``.

    q: (B, S_local, Hq, D); k, v: (B, S_local, Hkv, D). Returns o
    (B, S_local, Hq, D) in q's dtype."""
    axes = tuple(cfg.axes)
    sp = 1
    for a in axes:
        sp *= comm.axis_size(a)
    Hq, Hkv = q.shape[2], k.shape[2]
    if Hkv % sp != 0 or Hq % sp != 0:
        raise ValueError(
            f"Ulysses requires head counts divisible by SP degree: "
            f"Hq={Hq}, Hkv={Hkv}, SP={sp} (the paper's scalability limit)")

    # sequence-sharded -> head-sharded: gather the sequence (dim 1),
    # scatter the heads (dim 2)
    qh = comm.all_to_all(q, axes, 2, 1)
    kh = comm.all_to_all(k, axes, 2, 1)
    vh = comm.all_to_all(v, axes, 2, 1)

    # positions: the whole sequence, in shard-major order of the scheme
    pos = sequence_positions(cfg.seq_len, sp, cfg.seq_scheme, q.device)
    o = ops.flash_attention(qh, kh, vh, pos, pos, causal=cfg.causal,
                            window=cfg.window, scale=cfg.scale,
                            prefix_len=cfg.prefix_len, impl=cfg.block_impl)
    # head-sharded -> sequence-sharded
    return comm.all_to_all(o, axes, 1, 2)
