"""Collectives over the named sequence-parallel axes ``(sp_grp, sp_ring,
sp_team)``: the port's stand-in for the ``jax.lax`` collectives the JAX
package calls under ``shard_map``.

The per-shard code (``core.startrail``, ``models.runtime``,
``engine.paged_cache``, ``engine.sampling``) calls one interface:

  axis_size(axis) / axis_index(axis)
  all_gather(x, axis, dim)         tiled gather along ``dim`` over ``axis``
  ppermute(x, axes, perm)          (src, dst) pairs of linear ranks over
                                   ``axes``; a rank nobody sends to gets
                                   zeros (``jax.lax.ppermute``)
  psum / pmax / pmin(x, axes)      elementwise reductions
  psum_scatter(x, axis, dim)       tiled reduce-scatter along ``dim``

``axes`` is one name or a tuple. Linear ranks over several axes run
grp-major and team-minor, the order of ``Runtime.sp_rank`` and
``core.topology.StarTrailTopology.rank``: ``rank = (g*R + j)*C + t``.

Two implementations:

  SingleComm        P = 1: every collective is the identity (the engine on
                    one card).
  ThreadMesh(c, r)  P = c*c*r ranks as Python threads in one process,
                    exchanging tensors through a shared slot table and a
                    ``threading.Barrier``. It runs on the CPU (tests) and on
                    one card (``chip_smoke.py``). A rank that raises aborts
                    the barrier so the others fail at once, and a whole run
                    has a timeout, so a fault fails instead of hanging.

The multi-process NCCL/gloo implementation is later work (ROADMAP §A).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Sequence, Tuple, Union

import torch

from repro_torch.dist.sharding import SP_AXES

Axes = Union[str, Sequence[str]]


def _axes_tuple(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class SingleComm:
    """One rank: sizes 1, index 0, every collective the identity."""

    axes = SP_AXES

    def axis_size(self, axis: str) -> int:
        return 1

    def axis_index(self, axis: str) -> int:
        return 0

    def all_gather(self, x, axis: Axes, dim: int):
        return x

    def ppermute(self, x, axes: Axes, perm):
        # one rank: the identity unless nothing is sent to it
        return x if (0, 0) in [tuple(p) for p in perm] else torch.zeros_like(x)

    def psum(self, x, axes: Axes):
        return x

    def pmax(self, x, axes: Axes):
        return x

    def pmin(self, x, axes: Axes):
        return x

    def psum_scatter(self, x, axis: Axes, dim: int):
        return x


class ThreadMesh:
    """P = c*c*r ranks run as threads of one process (see module doc).

    ``run(fn, timeout)`` calls ``fn(comm)`` once per rank, each with its own
    ``comm`` (a :class:`_RankComm`), and returns the per-rank results in
    linear rank order.
    """

    def __init__(self, c: int, r: int):
        if c < 1 or r < 1:
            raise ValueError(f"need c, r >= 1, got c={c} r={r}")
        self.c, self.r = c, r
        self.size = c * c * r
        self.shape = {SP_AXES[0]: c, SP_AXES[1]: r, SP_AXES[2]: c}

    def coords(self, rank: int) -> Dict[str, int]:
        g, rem = divmod(rank, self.r * self.c)
        j, t = divmod(rem, self.c)
        return {SP_AXES[0]: g, SP_AXES[1]: j, SP_AXES[2]: t}

    def run(self, fn: Callable, timeout: float = 600.0) -> List:
        barrier = threading.Barrier(self.size, timeout=timeout)
        slots: List = [None] * self.size
        results: List = [None] * self.size
        errors: List = [None] * self.size
        comms = [_RankComm(self, rank, barrier, slots)
                 for rank in range(self.size)]

        def body(rank):
            try:
                results[rank] = fn(comms[rank])
            except BaseException as e:  # noqa: BLE001 (re-raised by run)
                errors[rank] = e
                barrier.abort()        # the other ranks fail at once

        threads = [threading.Thread(target=body, args=(i,), daemon=True,
                                    name=f"thread-mesh-rank{i}")
                   for i in range(self.size)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout)
        if any(th.is_alive() for th in threads):
            barrier.abort()
            for th in threads:
                th.join(5.0)
            raise TimeoutError(f"ThreadMesh run exceeded {timeout} s")
        # the root cause, not the BrokenBarrierErrors it caused elsewhere
        real = [e for e in errors if e is not None
                and not isinstance(e, threading.BrokenBarrierError)]
        if real:
            raise real[0]
        if any(e is not None for e in errors):
            raise next(e for e in errors if e is not None)
        return results


class _RankComm:
    """One rank's view of a :class:`ThreadMesh`."""

    axes = SP_AXES

    def __init__(self, mesh: ThreadMesh, rank: int, barrier, slots):
        self.mesh, self.rank = mesh, rank
        self._barrier, self._slots = barrier, slots
        self._coords = mesh.coords(rank)

    def axis_size(self, axis: str) -> int:
        return self.mesh.shape[axis]

    def axis_index(self, axis: str) -> int:
        return self._coords[axis]

    # ---- group bookkeeping ------------------------------------------------
    def _group(self, axes: Axes) -> List[int]:
        """Global ranks that share this rank's coordinates off ``axes``, in
        linear order over ``axes`` (grp-major, team-minor)."""
        names = _axes_tuple(axes)
        out = []
        for rank in range(self.mesh.size):
            co = self.mesh.coords(rank)
            if all(co[a] == self._coords[a] for a in SP_AXES
                   if a not in names):
                out.append(rank)
        return out   # ascending global rank == linear order over `axes`

    def _exchange(self, x):
        """Publish x, wait for every rank, return the slot table; a second
        barrier after the caller's reads keeps slots from being reused
        early (see ``_collective``)."""
        self._slots[self.rank] = x
        self._barrier.wait()
        return self._slots

    def _collective(self, x, axes: Axes, combine):
        group = self._group(axes)
        slots = self._exchange(x)
        out = combine([slots[g] for g in group], group.index(self.rank))
        self._barrier.wait()
        return out

    # ---- collectives ------------------------------------------------------
    def all_gather(self, x, axis: Axes, dim: int):
        return self._collective(x, axis, lambda xs, i: torch.cat(xs, dim))

    def psum(self, x, axes: Axes):
        def add(xs, i):
            out = xs[0].clone()
            for y in xs[1:]:
                out += y
            return out
        return self._collective(x, axes, add)

    def pmax(self, x, axes: Axes):
        def mx(xs, i):
            out = xs[0]
            for y in xs[1:]:
                out = torch.maximum(out, y)
            return out.clone()
        return self._collective(x, axes, mx)

    def pmin(self, x, axes: Axes):
        def mn(xs, i):
            out = xs[0]
            for y in xs[1:]:
                out = torch.minimum(out, y)
            return out.clone()
        return self._collective(x, axes, mn)

    def psum_scatter(self, x, axis: Axes, dim: int):
        def rs(xs, i):
            n = len(xs)
            parts = [y.chunk(n, dim)[i] for y in xs]
            out = parts[0].clone()
            for p in parts[1:]:
                out += p
            return out.contiguous()
        return self._collective(x, axis, rs)

    def ppermute(self, x, axes: Axes, perm):
        def perm_fn(xs, i):
            src = [s for s, d in perm if d == i]
            return xs[src[0]].clone() if src else torch.zeros_like(xs[i])
        return self._collective(x, axes, perm_fn)
