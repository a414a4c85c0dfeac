"""Collectives over the named mesh axes ``(data, sp_grp, sp_ring,
sp_team)``: the port's stand-in for the ``jax.lax`` collectives the JAX
package calls under ``shard_map``.

The per-shard code (``core.startrail``, ``models.runtime``,
``engine.paged_cache``, ``engine.sampling``) calls one interface:

  axis_size(axis) / axis_index(axis)
  all_gather(x, axis, dim)         tiled gather along ``dim`` over ``axis``
  ppermute(x, axes, perm)          (src, dst) pairs of linear ranks over
                                   ``axes``; a rank nobody sends to gets
                                   zeros (``jax.lax.ppermute``)
  ppermute_start(x, axes, perm)    the same, split in two: it returns a
    -> handle; handle.wait()       handle at once, and ``wait`` returns
                                   the result (below)
  psum / pmax / pmin(x, axes)      elementwise reductions
  psum_scatter(x, axis, dim)       tiled reduce-scatter along ``dim``
  all_to_all(x, axes, split_axis, concat_axis)
                                   ``jax.lax.all_to_all(..., tiled=True)``:
                                   the group's i-th slice of ``x`` along
                                   ``split_axis`` goes to member i, and the
                                   slices received are concatenated along
                                   ``concat_axis`` in member order

``axes`` is one name or a tuple. Linear ranks over several axes run in the
order of the tuple, major to minor; over the SP axes that is grp-major and
team-minor, the order of ``Runtime.sp_rank`` and
``core.topology.StarTrailTopology.rank``: ``rank = (g*R + j)*C + t``.

Four implementations:

  SingleComm        P = 1: every collective is the identity (the engine and
                    the trainer on one card); any axis has size 1.
  ThreadMesh(c, r, data)  data*c*c*r ranks as Python threads in one
                    process, data-major (``repro.dist.meshes.
                    local_mesh_for_tests``' layout), exchanging tensors
                    through a shared slot table and a ``threading.Barrier``.
                    It runs on the CPU (tests) and on one card
                    (``chip_smoke.py``). A rank that raises aborts the
                    barrier so the others fail at once, and a whole run has
                    a timeout, so a fault fails instead of hanging.
  TraceComm(c, r, data, pod)  one rank (rank 0) standing for a whole mesh
                    in a trace on the meta device (``launch.dryrun``):
                    each collective returns a meta tensor of the shape
                    the real one gives and logs the op (below).
  ProcessComm(c, r, data)  this process's rank of a mesh whose ranks are
                    processes (``dist.procs`` launches them, or
                    ``torchrun``), over ``torch.distributed``: gloo on the
                    CPU or for several ranks on one card, NCCL for one
                    rank per card. The ``ThreadMesh``'s coordinates,
                    autograd rules, signature check and ledger; its
                    reductions add in the same order, so both give the
                    same bits (the class doc).

The ``ThreadMesh`` collectives are differentiable, as the JAX ones are
under ``shard_map(check_vma=False)``: each is a ``torch.autograd.Function``
whose backward is the transposed collective (all_gather <-> psum_scatter,
psum <-> psum, ppermute <-> ppermute of the inverted pairs, all_to_all <->
all_to_all with split and concat swapped). A ppermute whose every pair is
(i, i) over the whole group (StarTrail's placement at C = 1) returns its
input: it moves nothing. The exchange
publishes detached tensors, so no autograd edge crosses ranks: each rank
differentiates its own graph, and the collectives in its backward meet the
other ranks' in the same order because every rank builds the same graph.
``pmax``/``pmin`` carry no gradient and raise on an input that needs one.
Each rank thread runs its backward on its own thread
(``torch.autograd.set_multithreading_enabled(False)``): on CUDA tensors the
autograd engine would otherwise queue every rank's backward nodes on one
worker thread per device, where the first collective waits forever for a
rank queued behind it.

Each rank publishes its collective's signature (op, axes, shape, dtype)
with its tensor; ranks that meet at a barrier in different collectives, or
with different shapes inside one group, raise instead of exchanging the
wrong tensors.

Every communicator keeps a :class:`CommLedger` per rank (``comm.ledger``;
``ThreadMesh.ledgers`` keeps them across ``run`` calls): each collective
adds the per-device wire bytes it moves, by the kind of the XLA collective
the JAX package would compile it to, from the result's shape and element
size alone (no device sync, no copy). Result bytes are converted as the
JAX ``obs.commlog`` converts HLO result buffers, with n the group size:

  all-gather           (n-1)/n   a member receives n-1 of n shards
  reduce-scatter       (n-1)     n-1 shard-sized messages
  collective-permute   1         the result is the message
  all-to-all           (n-1)/n   a member keeps its own slice
  all-reduce           1         psum / pmax / pmin: the result bytes

A group of one moves nothing and counts 0. The backward collectives of the
autograd rules (and any caller under ``ledger.backward()``) count under
``'backward'``, the rest under ``'forward'``.

The split-phase ppermute (``ppermute_start`` / ``wait``) is what lets the
StarTrail ring issue step s+1's transfer before step s's block kernel and
wait for it after (``core.startrail``, the JAX ``pipeline`` order).
``ppermute`` is start-then-wait, so both give the same values, run the same
signature check and identity shortcut and add the same ledger bytes; the
synchronous one copies on the rank's current stream, since nothing runs
between its start and its wait. The start is collective: every rank of
the mesh publishes its tensor and meets the others at the barrier, as a
synchronous collective does; only the copy is left in flight.

  * On CUDA tensors the copy runs on the receiving rank's comm stream (one
    ``torch.cuda.Stream`` per rank and device, made at its first transfer
    and kept by the ``ThreadMesh``). The comm stream first waits on an
    event the sender recorded on its current stream after it wrote ``x``,
    and on one the receiver recorded after it allocated the result on its
    own current stream, so the result stays in the compute stream's pool.
    ``record_stream`` tells the caching allocator that the comm stream
    uses both blocks, so a sender that frees ``x`` at once does not get its
    block back under the copy. ``wait`` makes the rank's current stream
    wait on the copy's event; the host never synchronises. Compute stays on
    each rank's current stream (``kernels/paged_decode.py`` shares one
    workspace per device on that). Every stream or event error raises: no
    path falls back to a synchronous copy.
  * On CPU tensors ``ppermute_start`` copies at once and ``wait`` returns
    the copy.
  * ``TraceComm`` defers the whole permute to ``wait``: the trace stands
    for the JAX package's CPU compile, whose collective-permutes are
    synchronous, so its log and its live storages are those of the
    synchronous order.

The pair has no autograd rule: ``ppermute_start`` raises on an input that
needs a gradient. The StarTrail ring calls it inside
``StarTrailAttention.forward``/``backward``, on tensors that need none.

Each ``_RankComm`` keeps an ``issue_log`` for one ``run``: every permute's
start and wait, and the block-kernel calls and ring scopes that
``core.startrail`` notes, each with its pass (``obs.commlog.
overlap_report`` reads the order). ``SingleComm`` and ``TraceComm`` keep
none.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Callable, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.dist.meshes import refine_grid
from repro_torch.dist.sharding import DATA_AXIS, MESH_AXES, SP_AXES

Axes = Union[str, Sequence[str]]


def _axes_tuple(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


WIRE_KINDS = ("all-gather", "collective-permute", "reduce-scatter",
              "all-to-all", "all-reduce")
PASSES = ("forward", "backward")


class CommLedger:
    """One rank's wire bytes and collective calls per kind, the forward
    and the backward apart (module doc). Host arithmetic on shapes only."""

    def __init__(self):
        self.phase = "forward"
        self._counting = True
        self.reset()

    def reset(self) -> None:
        self.bytes = {ph: dict.fromkeys(WIRE_KINDS, 0) for ph in PASSES}
        self.calls = {ph: dict.fromkeys(WIRE_KINDS, 0) for ph in PASSES}

    def add(self, kind: str, nbytes: int) -> None:
        if self._counting:
            self.bytes[self.phase][kind] += nbytes
            self.calls[self.phase][kind] += 1

    @contextlib.contextmanager
    def uncounted(self):
        """Leave the block's collectives out: bookkeeping that a
        ``ThreadMesh`` reads from shared memory instead of the wire (the
        optimizer's norm and int8-scale tables of ``train.step`` on a
        ``ProcessComm``), so the ledgers of both communicators stay
        comparable."""
        prev, self._counting = self._counting, False
        try:
            yield self
        finally:
            self._counting = prev

    @contextlib.contextmanager
    def backward(self):
        """Count the collectives of the block under ``'backward'``."""
        prev, self.phase = self.phase, "backward"
        try:
            yield self
        finally:
            self.phase = prev

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        return {ph: dict(self.bytes[ph]) for ph in PASSES}


def _wire_bytes(op: str, result_bytes: int, n: int) -> Tuple[str, int]:
    """(kind, per-device wire bytes) of collective ``op`` over a group of
    ``n`` whose result on this rank has ``result_bytes`` (module doc)."""
    kind, num, den = {
        "all_gather": ("all-gather", n - 1, n),
        "psum_scatter": ("reduce-scatter", n - 1, 1),
        "ppermute": ("collective-permute", 1, 1),
        "all_to_all": ("all-to-all", n - 1, n),
        "psum": ("all-reduce", 1, 1),
        "pmax": ("all-reduce", 1, 1),
        "pmin": ("all-reduce", 1, 1),
    }[op]
    return kind, (result_bytes * num // den if n > 1 else 0)


def _is_identity(perm, n: int) -> bool:
    """Every pair (i, i), and every one of the group's n members in one."""
    pairs = [tuple(p) for p in perm]
    return (all(s == d for s, d in pairs)
            and sorted(s for s, _ in pairs) == list(range(n)))


class _Deferred:
    """The handle of a permute that runs at ``wait`` (``TraceComm``)."""

    __slots__ = ("_fn", "_out")

    def __init__(self, fn):
        self._fn, self._out = fn, None

    def wait(self):
        if self._fn is not None:
            self._out, self._fn = self._fn(), None
        return self._out


class _Transfer:
    """A permute's handle: ``done`` is the event after its copy on the
    comm stream (None when the result is already there), ``log`` the
    rank's issue log, where ``wait`` notes ``key`` once (none without
    one)."""

    __slots__ = ("_out", "_done", "_log", "_key")

    def __init__(self, out, done=None, log=None, key=None):
        self._out, self._done, self._log, self._key = out, done, log, key

    def wait(self):
        if self._done is not None:
            torch.cuda.current_stream(self._out.device).wait_event(
                self._done)
            self._done = None
        if self._key is not None:
            self._log.append(("wait", self._key[0], self._key[1]))
            self._key = None
        return self._out


class SingleComm:
    """One rank: sizes 1, index 0, every collective the identity (and
    nothing on the wire: its ledger stays at 0)."""

    def __init__(self):
        self.ledger = CommLedger()
        self.ledgers = [self.ledger]

    def reset_ledgers(self) -> None:
        self.ledger.reset()

    def axis_size(self, axis: str) -> int:
        return 1

    def axis_index(self, axis: str) -> int:
        return 0

    def all_gather(self, x, axis: Axes, dim: int):
        return x

    def ppermute(self, x, axes: Axes, perm):
        # one rank: the identity unless nothing is sent to it
        return x if (0, 0) in [tuple(p) for p in perm] else torch.zeros_like(x)

    def ppermute_start(self, x, axes: Axes, perm):
        return _Transfer(self.ppermute(x, axes, perm))

    def psum(self, x, axes: Axes):
        return x

    def pmax(self, x, axes: Axes):
        return x

    def pmin(self, x, axes: Axes):
        return x

    def psum_scatter(self, x, axis: Axes, dim: int):
        return x

    def all_to_all(self, x, axes: Axes, split_axis: int, concat_axis: int):
        return x


def mesh_coords(c: int, r: int, data: int = 1,
                placement: str = "team_inner") -> List[Dict[str, int]]:
    """Every rank's coordinate on every mesh axis, in rank order: rank
    ``i`` is data replica ``i // P`` (P = c*c*r) and, within it, SP member
    ``i % P`` at the (g, j, t) that ``dist.meshes.refine_grid`` gives it
    under ``placement`` (``ThreadMesh`` and ``ProcessComm`` alike)."""
    sp_size = c * c * r
    grid = refine_grid(np.arange(sp_size), c, placement)
    sp_coords = {int(grid[g, j, t]): (g, j, t)
                 for g in range(c) for j in range(r) for t in range(c)}
    return [dict(zip(MESH_AXES, (d,) + sp_coords[q]))
            for d in range(data) for q in range(sp_size)]


class ThreadMesh:
    """data*c*c*r ranks run as threads of one process (see module doc).

    Thread ``i`` is data replica ``i // P`` (P = c*c*r) and, within it, SP
    member ``i % P``, whose (g, j, t) coordinates come from
    ``dist.meshes.refine_grid`` under ``placement``. Values do not depend on
    the placement: every collective groups and orders ranks by their
    coordinates. ``run(fn, timeout)`` calls ``fn(comm)`` once per rank,
    each with its own ``comm`` (a :class:`_RankComm`), and returns the
    results in thread order. ``ledgers[rank]`` is thread ``rank``'s
    :class:`CommLedger`, kept across runs until ``reset_ledgers()``.
    """

    def __init__(self, c: int, r: int, data: int = 1,
                 placement: str = "team_inner"):
        if c < 1 or r < 1 or data < 1:
            raise ValueError(f"need positive sizes, got c={c} r={r} "
                             f"data={data}")
        self.c, self.r, self.data = c, r, data
        self.placement = placement
        self.sp_size = c * c * r
        self.size = data * self.sp_size
        self.shape = {DATA_AXIS: data, SP_AXES[0]: c, SP_AXES[1]: r,
                      SP_AXES[2]: c}
        self._coords = mesh_coords(c, r, data, placement)
        self.ledgers = [CommLedger() for _ in range(self.size)]
        # each rank's comm stream per CUDA device (module doc)
        self.comm_streams: List[Dict[int, object]] = [
            {} for _ in range(self.size)]

    def reset_ledgers(self) -> None:
        for ledger in self.ledgers:
            ledger.reset()

    def coords(self, rank: int) -> Dict[str, int]:
        """Thread ``rank``'s coordinate on every mesh axis."""
        return dict(self._coords[rank])

    def run(self, fn: Callable, timeout: float = 600.0) -> List:
        barrier = threading.Barrier(self.size, timeout=timeout)
        slots: List = [None] * self.size
        results: List = [None] * self.size
        errors: List = [None] * self.size
        comms = [_RankComm(self, rank, barrier, slots)
                 for rank in range(self.size)]

        def body(rank):
            try:
                # this rank's backward runs on this thread (module doc)
                with torch.autograd.set_multithreading_enabled(False):
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

    def __init__(self, mesh: ThreadMesh, rank: int, barrier, slots):
        self.mesh, self.rank = mesh, rank
        self._barrier, self._slots = barrier, slots
        self._coords = mesh.coords(rank)
        self._groups: Dict[Tuple[str, ...], List[int]] = {}
        self.ledger = mesh.ledgers[rank]
        self.issue_log: List[Tuple] = []
        self._transfers = 0

    def comm_stream(self, device):
        """This rank's comm stream on CUDA ``device`` ('cuda' meaning the
        current device), made once."""
        index = torch.device(device).index
        if index is None:
            index = torch.cuda.current_device()
        streams = self.mesh.comm_streams[self.rank]
        if index not in streams:
            streams[index] = torch.cuda.Stream(index)
        return streams[index]

    def axis_size(self, axis: str) -> int:
        return self.mesh.shape[axis]

    def axis_index(self, axis: str) -> int:
        return self._coords[axis]

    # ---- group bookkeeping ------------------------------------------------
    def _group(self, names: Tuple[str, ...]) -> List[int]:
        """Threads that share this rank's coordinates off ``names``, in
        linear order over ``names`` (the first name major)."""
        if names not in self._groups:
            out = []
            for rank in range(self.mesh.size):
                co = self.mesh.coords(rank)
                if all(co[a] == self._coords[a] for a in MESH_AXES
                       if a not in names):
                    out.append((tuple(co[a] for a in names), rank))
            self._groups[names] = [rank for _, rank in sorted(out)]
        return self._groups[names]

    def _collective(self, op: str, x, axes: Axes, combine, event=None):
        """Publish (signature, x, event), wait for every rank, check that
        they all run this collective, combine this rank's group, and wait
        again so no slot is overwritten before every rank has read it.
        ``combine(tensors, i, events)`` returns the result, or a tuple
        whose first item is the result (returned as it is)."""
        names = _axes_tuple(axes)
        sig = (op, names, tuple(x.shape), x.dtype)
        group = self._group(names)
        self._slots[self.rank] = (sig, x, event)
        self._barrier.wait()
        slots = self._slots
        for other in range(self.mesh.size):
            theirs = slots[other][0]
            if (theirs[:2] != sig[:2]
                    or (other in group and theirs != sig)):
                raise RuntimeError(
                    f"ThreadMesh collective mismatch: rank {self.rank} runs "
                    f"{sig}, rank {other} runs {theirs}")
        res = combine([slots[g][1] for g in group], group.index(self.rank),
                      [slots[g][2] for g in group])
        self._barrier.wait()
        out = res[0] if isinstance(res, tuple) else res
        self.ledger.add(*_wire_bytes(op, out.numel() * out.element_size(),
                                    len(group)))
        return res

    # ---- the exchanges (no autograd: callers pass detached tensors) -------
    def _all_gather(self, x, axis: Axes, dim: int):
        return self._collective("all_gather", x, axis,
                                lambda xs, i, _: torch.cat(xs, dim))

    def _psum(self, x, axes: Axes):
        def add(xs, i, _):
            out = xs[0].clone()
            for y in xs[1:]:
                out += y
            return out
        return self._collective("psum", x, axes, add)

    def _psum_scatter(self, x, axis: Axes, dim: int):
        def rs(xs, i, _):
            n = len(xs)
            parts = [y.chunk(n, dim)[i] for y in xs]
            out = parts[0].clone()
            for p in parts[1:]:
                out += p
            return out.contiguous()
        return self._collective("psum_scatter", x, axis, rs)

    def _ppermute(self, x, axes: Axes, perm):
        """The synchronous permute: start-then-wait with nothing between,
        so the copy runs on this rank's current stream."""
        def perm_fn(xs, i, _):
            src = [s for s, d in perm if d == i]
            return xs[src[0]].clone() if src else torch.zeros_like(xs[i])
        out = self._collective("ppermute", x, axes, perm_fn)
        self._log_pair()
        return out

    def _log_pair(self) -> None:
        """A permute started and waited for at once, in the issue log."""
        key = (self._transfers, self.ledger.phase)
        self._transfers += 1
        self.issue_log += [("start",) + key, ("wait",) + key]

    def _ppermute_start(self, x, axes: Axes, perm) -> _Transfer:
        """Publish ``x`` and leave this rank's copy in flight (module
        doc); the start and the handle's wait go into ``issue_log``."""
        cuda = x.device.type == "cuda"
        sent = None
        if cuda:
            # the copy is a memcpy of a contiguous block, on the comm stream
            x = x.contiguous()
            sent = torch.cuda.Event()
            sent.record(torch.cuda.current_stream(x.device))

        def perm_fn(xs, i, events):
            src = [s for s, d in perm if d == i]
            if not src:
                return torch.zeros_like(xs[i]), None
            theirs = xs[src[0]]
            if not cuda:
                return theirs.clone(), None
            out = torch.empty_like(theirs)     # in the compute stream's pool
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(out.device))
            stream = self.comm_stream(out.device)
            stream.wait_event(events[src[0]])
            stream.wait_event(ready)
            with torch.cuda.stream(stream):
                out.copy_(theirs)
            theirs.record_stream(stream)
            out.record_stream(stream)
            done = torch.cuda.Event()
            done.record(stream)
            return out, done

        out, done = self._collective("ppermute", x, axes, perm_fn, sent)
        key = (self._transfers, self.ledger.phase)
        self._transfers += 1
        self.issue_log.append(("start",) + key)
        return _Transfer(out, done, self.issue_log, key)

    def _all_to_all(self, x, axes: Axes, split_axis: int, concat_axis: int):
        def a2a(xs, i, _):
            n = len(xs)
            if xs[0].shape[split_axis] % n:
                raise ValueError(
                    f"all_to_all: split axis {split_axis} of length "
                    f"{xs[0].shape[split_axis]} does not divide over {n}")
            return torch.cat([y.chunk(n, split_axis)[i] for y in xs],
                             concat_axis)
        return self._collective("all_to_all", x, axes, a2a)

    def _extreme(self, op: str, x, axes: Axes, pick):
        if self._tracked(x):
            raise ValueError(
                f"{op} carries no gradient: detach its input (the JAX "
                "stop_gradient) instead of dropping the gradient silently")

        def red(xs, i, _):
            out = xs[0]
            for y in xs[1:]:
                out = pick(out, y)
            return out.clone()
        return self._collective(op, x, axes, red)

    # ---- collectives: differentiable where the input needs a gradient ----
    @staticmethod
    def _tracked(x) -> bool:
        return torch.is_grad_enabled() and x.requires_grad

    def all_gather(self, x, axis: Axes, dim: int):
        if self._tracked(x):
            return _AllGather.apply(x, self, axis, dim)
        return self._all_gather(x.detach(), axis, dim)

    def psum(self, x, axes: Axes):
        if self._tracked(x):
            return _PSum.apply(x, self, axes)
        return self._psum(x.detach(), axes)

    def psum_scatter(self, x, axis: Axes, dim: int):
        if self._tracked(x):
            return _PSumScatter.apply(x, self, axis, dim)
        return self._psum_scatter(x.detach(), axis, dim)

    def ppermute(self, x, axes: Axes, perm):
        if _is_identity(perm, len(self._group(_axes_tuple(axes)))):
            return self._identity(x)
        if self._tracked(x):
            return _PPermute.apply(x, self, axes, perm)
        return self._ppermute(x.detach(), axes, perm)

    def ppermute_start(self, x, axes: Axes, perm):
        """``ppermute`` in two halves: the handle's ``wait()`` returns
        the result (module doc). No gradient flows through the pair."""
        if _is_identity(perm, len(self._group(_axes_tuple(axes)))):
            return _Transfer(self._identity(x))
        if self._tracked(x):
            raise ValueError(
                "ppermute_start carries no gradient: call it on a detached "
                "tensor, or use ppermute, whose backward is the inverse "
                "permutation")
        return self._ppermute_start(x.detach(), axes, perm)

    def _identity(self, x):
        """A permute that moves nothing returns its input; the issue log
        keeps it as a start and a wait, as XLA keeps it in the compiled
        program."""
        self._log_pair()
        return x

    def all_to_all(self, x, axes: Axes, split_axis: int, concat_axis: int):
        if self._tracked(x):
            return _AllToAll.apply(x, self, axes, split_axis, concat_axis)
        return self._all_to_all(x.detach(), axes, split_axis, concat_axis)

    def pmax(self, x, axes: Axes):
        return self._extreme("pmax", x, axes, torch.maximum)

    def pmin(self, x, axes: Axes):
        return self._extreme("pmin", x, axes, torch.minimum)


# ---------------------------------------------------------------------------
# autograd rules: each backward is the transposed collective
# ---------------------------------------------------------------------------

class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis, dim):
        ctx.comm, ctx.axis, ctx.dim = comm, axis, dim
        return comm._all_gather(x.detach(), axis, dim)

    @staticmethod
    def backward(ctx, g):
        with ctx.comm.ledger.backward():
            return (ctx.comm._psum_scatter(g.contiguous(), ctx.axis,
                                           ctx.dim), None, None, None)


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis, dim):
        ctx.comm, ctx.axis, ctx.dim = comm, axis, dim
        return comm._psum_scatter(x.detach(), axis, dim)

    @staticmethod
    def backward(ctx, g):
        with ctx.comm.ledger.backward():
            return (ctx.comm._all_gather(g.contiguous(), ctx.axis, ctx.dim),
                    None, None, None)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes):
        ctx.comm, ctx.axes = comm, axes
        return comm._psum(x.detach(), axes)

    @staticmethod
    def backward(ctx, g):
        with ctx.comm.ledger.backward():
            return ctx.comm._psum(g.contiguous(), ctx.axes), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes, perm):
        ctx.comm, ctx.axes = comm, axes
        ctx.inverse = [(d, s) for s, d in perm]
        return comm._ppermute(x.detach(), axes, perm)

    @staticmethod
    def backward(ctx, g):
        with ctx.comm.ledger.backward():
            return (ctx.comm._ppermute(g.contiguous(), ctx.axes,
                                       ctx.inverse), None, None, None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes, split_axis, concat_axis):
        ctx.comm, ctx.axes = comm, axes
        ctx.split_axis, ctx.concat_axis = split_axis, concat_axis
        return comm._all_to_all(x.detach(), axes, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        with ctx.comm.ledger.backward():
            return (ctx.comm._all_to_all(g.contiguous(), ctx.axes,
                                         ctx.concat_axis, ctx.split_axis),
                    None, None, None, None)


# ---------------------------------------------------------------------------
# the trace communicator: one rank standing for the mesh
# ---------------------------------------------------------------------------

# the XLA collective each op compiles to (``roofline.hlo``'s kinds)
HLO_KINDS = {"all_gather": "all-gather", "psum": "all-reduce",
             "pmax": "all-reduce", "pmin": "all-reduce",
             "psum_scatter": "reduce-scatter",
             "ppermute": "collective-permute", "all_to_all": "all-to-all"}


class TraceComm(_RankComm):
    """Rank 0 of a mesh of ``pod * data * c*c*r`` ranks, for a trace on
    the meta device (``launch.dryrun``). Nothing is exchanged: each
    collective returns a new meta tensor of the shape the collective gives
    on a real mesh, and appends ``(op, kind, result_bytes, group_size,
    phase, dtype)`` to ``log`` (``kind`` the XLA collective it compiles
    to, ``phase`` forward or backward), besides counting its wire bytes in
    ``ledger`` as a ``ThreadMesh`` rank does. A collective over a group of
    one, and a ppermute that moves nothing (which returns its input), are
    logged too, as XLA keeps them in the compiled program; they move
    nothing on the wire. The autograd rules are the ``ThreadMesh``'s
    (this class is a ``_RankComm``: the same autograd Functions call its
    exchanges).

    Why one rank stands for all: every rank of a plan holds the same
    shapes. Sharding rules split each leaf into equal blocks, the batch
    splits into equal rows per data replica and the sequence into equal
    slices per SP rank, and every collective gives equal shapes on every
    member, so rank 0's argument, output and temporary bytes and its
    collective bytes are every rank's. Its FLOPs and accessed bytes are
    every rank's too except where the work depends on the rank's
    positions: under causal ring-block skipping (``block_skip``, the
    sliding-window layouts) the live ring steps depend on the rank, and
    rank 0, which holds the earliest queries, skips the most; the zigzag
    and full-mask layouts run every step on every rank. ``run(fn)`` calls
    ``fn(self)`` once, so a step builder that takes a ``ThreadMesh`` runs
    its rank-0 body on it."""

    def __init__(self, c: int, r: int, data: int = 1, pod: int = 1,
                 placement: str = "team_inner"):
        if min(c, r, data, pod) < 1:
            raise ValueError(f"need positive sizes, got c={c} r={r} "
                             f"data={data} pod={pod}")
        self.c, self.r, self.data, self.pod = c, r, data, pod
        self.placement = placement
        self.sp_size = c * c * r
        self.size = pod * data * self.sp_size
        self.shape = {"pod": pod, DATA_AXIS: data, SP_AXES[0]: c,
                      SP_AXES[1]: r, SP_AXES[2]: c}
        self.mesh, self.rank = self, 0
        self._coords = dict.fromkeys(self.shape, 0)
        self._groups = {}
        self.ledger = CommLedger()
        self.log: List[Tuple[str, str, int, int, str, torch.dtype]] = []
        self.issue_log = None

    def run(self, fn: Callable, timeout: float = 600.0) -> List:
        return [fn(self)]

    def _group(self, names: Tuple[str, ...]) -> List[int]:
        n = 1
        for a in names:
            n *= self.shape[a]
        return list(range(n))

    def _result(self, op: str, x, axes: Axes, shape):
        """A meta tensor of ``shape`` in x's dtype, the op logged."""
        n = len(self._group(_axes_tuple(axes)))
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        nbytes = out.numel() * out.element_size()
        self.log.append((op, HLO_KINDS[op], nbytes, n, self.ledger.phase,
                         x.dtype))
        self.ledger.add(*_wire_bytes(op, nbytes, n))
        return out

    def _all_gather(self, x, axis: Axes, dim: int):
        n = len(self._group(_axes_tuple(axis)))
        shape = list(x.shape)
        shape[dim] *= n
        return self._result("all_gather", x, axis, shape)

    def _psum(self, x, axes: Axes):
        return self._result("psum", x, axes, x.shape)

    def _psum_scatter(self, x, axis: Axes, dim: int):
        n = len(self._group(_axes_tuple(axis)))
        shape = list(x.shape)
        if shape[dim] % n:
            raise ValueError(f"psum_scatter: dim {dim} of length "
                             f"{shape[dim]} does not divide over {n}")
        shape[dim] //= n
        return self._result("psum_scatter", x, axis, shape)

    def ppermute(self, x, axes: Axes, perm):
        if _is_identity(perm, len(self._group(_axes_tuple(axes)))):
            self.log.append(("ppermute", HLO_KINDS["ppermute"],
                             x.numel() * x.element_size(),
                             len(self._group(_axes_tuple(axes))),
                             self.ledger.phase, x.dtype))
            return x
        return super().ppermute(x, axes, perm)

    def ppermute_start(self, x, axes: Axes, perm):
        """The permute runs at ``wait`` (module doc)."""
        return _Deferred(lambda: self.ppermute(x.contiguous(), axes, perm))

    def _ppermute(self, x, axes: Axes, perm):
        return self._result("ppermute", x, axes, x.shape)

    def _all_to_all(self, x, axes: Axes, split_axis: int, concat_axis: int):
        n = len(self._group(_axes_tuple(axes)))
        shape = list(x.shape)
        if shape[split_axis] % n:
            raise ValueError(
                f"all_to_all: split axis {split_axis} of length "
                f"{shape[split_axis]} does not divide over {n}")
        shape[split_axis] //= n
        shape[concat_axis] *= n
        return self._result("all_to_all", x, axes, shape)

    def _extreme(self, op: str, x, axes: Axes, pick):
        if self._tracked(x):
            raise ValueError(
                f"{op} carries no gradient: detach its input (the JAX "
                "stop_gradient) instead of dropping the gradient silently")
        return self._result(op, x, axes, x.shape)


# ---------------------------------------------------------------------------
# ranks as processes: torch.distributed (gloo, NCCL)
# ---------------------------------------------------------------------------

_OPS = ("all_gather", "psum", "psum_scatter", "ppermute", "all_to_all",
        "pmax", "pmin")
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
           torch.bool)
_SIG_DIMS = 8                     # shape entries a signature carries
_SIG_LEN = 4 + _SIG_DIMS          # op, axes, ndim, dtype, then the shape


def _signature(op: str, names: Tuple[str, ...], x) -> List[int]:
    """(op, axes, shape, dtype) of a collective as ``_SIG_LEN`` ints: the
    axes in their order as base-5 digits (1 + their ``MESH_AXES`` index),
    the shape padded with -1."""
    if x.dim() > _SIG_DIMS or x.dtype not in _DTYPES:
        raise ValueError(f"{op}: no signature for a {x.dim()}-d {x.dtype} "
                         f"tensor (at most {_SIG_DIMS} dims of "
                         f"{[str(d) for d in _DTYPES]})")
    axes = sum((MESH_AXES.index(a) + 1) * 5 ** i for i, a in enumerate(names))
    return ([_OPS.index(op), axes, x.dim(), _DTYPES.index(x.dtype)]
            + list(x.shape) + [-1] * (_SIG_DIMS - x.dim()))


def _describe(sig: Sequence[int]) -> Tuple:
    """A signature back as (op, axes, shape, dtype), the ``ThreadMesh``'s
    form of it."""
    names, code = [], sig[1]
    while code:
        code, digit = divmod(code, 5)
        names.append(MESH_AXES[digit - 1])
    return (_OPS[sig[0]], tuple(names), tuple(sig[4:4 + sig[2]]),
            _DTYPES[sig[3]])


class _PendingTransfer:
    """A permute's handle under NCCL: ``wait`` makes the current stream
    wait on the transfer's work (no host sync) and notes ``key`` in the
    issue log."""

    __slots__ = ("_works", "_finish", "_log", "_key", "_out")

    def __init__(self, works, finish, log, key):
        self._works, self._finish, self._log, self._key = (works, finish,
                                                           log, key)
        self._out = None

    def wait(self):
        if self._finish is not None:
            for work in self._works:
                work.wait()
            self._out, self._finish, self._works = self._finish(), None, ()
            self._log.append(("wait", self._key[0], self._key[1]))
        return self._out


class ProcessComm(_RankComm):
    """This process's rank of a mesh of ``data*c*c*r`` ranks, one process
    each, over ``torch.distributed``: the interface, autograd rules and
    ledger of a ``ThreadMesh`` rank (``_RankComm``), exchanging through the
    backend the process group was initialised with (``dist.procs`` does
    that). Rank ``dist.get_rank()`` has ``ThreadMesh``'s coordinates
    (``mesh_coords``).

    *Groups.* Every set of ranks that shares its coordinates off some
    subset of the mesh axes gets a process group, made at construction by
    every rank in one fixed order (``dist.new_group`` is collective).
    Within a group, results are ordered by the linear order over the axes
    named, whatever the group's own rank order.

    *Values.* Every reduction adds (or takes the max of) the members'
    contributions in the group's linear order, as the ``ThreadMesh`` does,
    so results do not depend on the backend's algorithm and replicas hold
    the same bits: ``psum`` is an all-to-all of equal chunks, each member
    summing its chunk over the members in order, then an all-gather of the
    sums (the wire bytes of a ring all-reduce); ``psum_scatter`` is the
    all-to-all and the sum; ``pmax``/``pmin`` gather and pick. The other
    collectives move bytes (``all_gather_into_tensor``,
    ``all_to_all_single``, ``batch_isend_irecv`` with global peer ranks),
    every tensor as its raw bytes, so any dtype crosses.

    *Signatures.* Before each collective the group all-gathers its
    members' (op, axes, shape, dtype); a mismatch raises on every member
    before anything is exchanged. ``signature_s`` and ``signature_calls``
    count the host time and calls this costs.

    *Backends.* The caller names it; nothing switches backend on a fault.
    ``nccl`` takes CUDA tensors where they are and raises at construction
    when two ranks share a card (NCCL takes one rank per card). ``gloo``
    runs on the CPU, and for several ranks on one card: each CUDA tensor is
    copied into pinned host memory before the exchange and back after it.

    *Split-phase permutes.* Under NCCL ``ppermute_start`` returns the work
    handles, and ``wait`` makes the current stream wait on them (NCCL
    copies on streams of its own: there is no ``comm_stream``). Under
    gloo the exchange completes at the start (its ``wait`` returns the
    result), so ``obs.commlog.overlap_report`` reads no timed overlap.
    """

    def __init__(self, c: int, r: int, data: int = 1,
                 placement: str = "team_inner", timeout: float = 600.0):
        import datetime

        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("ProcessComm needs an initialised process "
                               "group (dist.procs.ProcessMesh makes one)")
        if min(c, r, data) < 1:
            raise ValueError(f"need positive sizes, got c={c} r={r} "
                             f"data={data}")
        self.c, self.r, self.data = c, r, data
        self.placement = placement
        self.sp_size = c * c * r
        self.size = data * self.sp_size
        if dist.get_world_size() != self.size:
            raise ValueError(f"mesh (data={data}, c={c}, r={r}) has "
                             f"{self.size} ranks, the process group "
                             f"{dist.get_world_size()}")
        self.backend = dist.get_backend()
        if self.backend not in ("gloo", "nccl"):
            raise ValueError(f"backend must be gloo or nccl, got "
                             f"{self.backend!r}")
        self.rank = dist.get_rank()
        self.shape = {DATA_AXIS: data, SP_AXES[0]: c, SP_AXES[1]: r,
                      SP_AXES[2]: c}
        self._all_coords = mesh_coords(c, r, data, placement)
        self.mesh = self
        self._coords = self.coords(self.rank)
        self._groups: Dict[Tuple[str, ...], List[int]] = {}
        self.ledger = CommLedger()
        self.ledgers = [self.ledger]
        self.issue_log: List[Tuple] = []
        self._transfers = 0
        self.signature_s, self.signature_calls = 0.0, 0
        # the all-gather into one tensor, under its newer name where the
        # installed torch has it
        self._gather_into = getattr(dist, "all_gather_single",
                                    dist.all_gather_into_tensor)
        # where the backend takes tensors: the rank's card under NCCL
        self.wire_device = (torch.device("cuda", torch.cuda.current_device())
                            if self.backend == "nccl"
                            else torch.device("cpu"))
        if self.backend == "nccl":
            self._one_rank_per_card(dist)
        self._pgs = self._make_groups(
            dist, datetime.timedelta(seconds=timeout))
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.wire_device.index])
        else:
            dist.barrier()

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank ``rank``'s coordinate on every mesh axis."""
        return dict(self._all_coords[rank])

    def reset_ledgers(self) -> None:
        self.ledger.reset()

    # ---- construction -----------------------------------------------------
    def _one_rank_per_card(self, dist) -> None:
        store = dist.distributed_c10d._get_default_store()
        card = str(torch.cuda.get_device_properties(self.wire_device).uuid)
        store.set(f"repro_torch/card/{self.rank}", card)
        for other in range(self.size):
            theirs = store.get(f"repro_torch/card/{other}").decode()
            if other != self.rank and theirs == card:
                raise RuntimeError(
                    f"nccl: ranks {self.rank} and {other} share the card "
                    f"{card}, and NCCL takes one rank per card; run several "
                    "ranks on one card with backend='gloo'")

    def _make_groups(self, dist, timeout) -> Dict[Tuple[int, ...], object]:
        sets = set()
        for k in range(1, len(MESH_AXES) + 1):
            for names in itertools.combinations(MESH_AXES, k):
                for co in self._all_coords:
                    members = tuple(
                        q for q, other in enumerate(self._all_coords)
                        if all(other[a] == co[a] for a in MESH_AXES
                               if a not in names))
                    if len(members) > 1:
                        sets.add(members)
        pgs = {}
        for members in sorted(sets, key=lambda m: (len(m), m)):
            pg = (dist.group.WORLD if len(members) == self.size
                  else dist.new_group(list(members), timeout=timeout))
            if self.rank in members:
                pgs[members] = pg
        return pgs

    # ---- wire helpers -----------------------------------------------------
    def _layout(self, names: Tuple[str, ...]):
        """(the group in linear order, its process group, the linear index
        of each group rank, the group rank of each linear index)."""
        grp = self._group(names)
        ranked = sorted(grp)
        lin = [grp.index(q) for q in ranked]
        return grp, self._pgs.get(tuple(ranked)), lin, [
            ranked.index(q) for q in grp]

    def _wire(self, x) -> torch.Tensor:
        """x's bytes, flat, where the backend takes them: in pinned host
        memory for a CUDA tensor under gloo (the copy waits for x)."""
        flat = x.contiguous().reshape(-1).view(torch.uint8)
        if self.backend == "gloo" and flat.is_cuda:
            host = torch.empty(flat.shape, dtype=torch.uint8,
                               pin_memory=True)
            host.copy_(flat)
            return host
        return flat

    def _empty_wire(self, nbytes: int, like) -> torch.Tensor:
        if self.backend == "gloo":
            return torch.empty(nbytes, dtype=torch.uint8,
                               pin_memory=like.is_cuda)
        return torch.empty(nbytes, dtype=torch.uint8, device=like.device)

    @staticmethod
    def _unwire(buf, like) -> torch.Tensor:
        """Bytes back as a flat tensor of ``like``'s dtype on its device."""
        t = buf.view(like.dtype)
        return t.to(like.device, non_blocking=True) \
            if t.device != like.device else t

    def _check(self, op: str, names: Tuple[str, ...], x, pg, grp) -> None:
        """The group's members all run (op, axes, shape, dtype), or every
        member raises."""
        t0 = time.perf_counter()
        sig = _signature(op, names, x)
        mine = torch.tensor(sig, dtype=torch.int64, device=self.wire_device)
        rows = torch.empty(len(grp) * _SIG_LEN, dtype=torch.int64,
                           device=self.wire_device)
        self._gather_into(rows, mine, group=pg)
        rows = rows.view(len(grp), _SIG_LEN).tolist()
        self.signature_s += time.perf_counter() - t0
        self.signature_calls += 1
        for other, row in zip(sorted(grp), rows):
            if row != sig:
                raise RuntimeError(
                    f"ProcessComm collective mismatch: rank {self.rank} runs "
                    f"{_describe(sig)}, rank {other} runs {_describe(row)}")

    def _all_to_all_flat(self, flat, pg) -> torch.Tensor:
        """Equal parts of ``flat``: part k to group rank k; returns the
        parts received, part k from group rank k."""
        import torch.distributed as dist

        send = self._wire(flat)
        recv = self._empty_wire(send.numel(), flat)
        dist.all_to_all_single(recv, send, group=pg)
        return self._unwire(recv, flat)

    def _gather_flat(self, flat, pg, n: int) -> torch.Tensor:
        """Every member's ``flat``, concatenated in group-rank order."""
        send = self._wire(flat)
        recv = self._empty_wire(n * send.numel(), flat)
        self._gather_into(recv, send, group=pg)
        return self._unwire(recv, flat)

    def _count(self, op: str, out, n: int) -> None:
        self.ledger.add(*_wire_bytes(op, out.numel() * out.element_size(),
                                    n))

    @staticmethod
    def _ordered_sum(parts):
        """parts[0] + parts[1] + ... in that order, as ``ThreadMesh``."""
        out = parts[0].clone()
        for p in parts[1:]:
            out += p
        return out

    # ---- the exchanges (no autograd: callers pass detached tensors) -------
    def _all_gather(self, x, axis: Axes, dim: int):
        names = _axes_tuple(axis)
        grp, pg, lin, _ = self._layout(names)
        n = len(grp)
        if n == 1:
            out = torch.cat([x], dim)
        else:
            self._check("all_gather", names, x, pg, grp)
            rows = self._gather_flat(x, pg, n).view(n, *x.shape)
            xs = [None] * n
            for k, row in enumerate(rows):
                xs[lin[k]] = row
            out = torch.cat(xs, dim)
        self._count("all_gather", out, n)
        return out

    def _psum(self, x, axes: Axes):
        names = _axes_tuple(axes)
        grp, pg, _, at = self._layout(names)
        n = len(grp)
        if n == 1:
            out = x.clone()
        else:
            self._check("psum", names, x, pg, grp)
            flat = x.contiguous().reshape(-1)
            m = flat.numel()
            chunk = -(-m // n)
            if chunk * n != m:
                flat = torch.cat([flat, flat.new_zeros(chunk * n - m)])
            parts = self._all_to_all_flat(flat, pg).view(n, chunk)
            mine = self._ordered_sum([parts[at[j]] for j in range(n)])
            out = self._gather_flat(mine, pg, n)[:m].view(x.shape)
        self._count("psum", out, n)
        return out

    def _split_send(self, x, split_axis: int, n: int, lin):
        """x cut in n along ``split_axis``, the part for linear member j
        going to its group rank: (the flat send buffer, the part shape)."""
        parts = x.chunk(n, split_axis)
        return (torch.cat([parts[lin[k]].reshape(-1) for k in range(n)]),
                parts[0].shape)

    def _psum_scatter(self, x, axis: Axes, dim: int):
        names = _axes_tuple(axis)
        grp, pg, lin, at = self._layout(names)
        n = len(grp)
        if x.shape[dim] % n:
            raise ValueError(f"psum_scatter: dim {dim} of length "
                             f"{x.shape[dim]} does not divide over {n}")
        if n == 1:
            out = x.clone()
        else:
            self._check("psum_scatter", names, x, pg, grp)
            send, part = self._split_send(x, dim, n, lin)
            got = self._all_to_all_flat(send, pg).view(n, -1)
            out = self._ordered_sum([got[at[j]] for j in range(n)]
                                    ).view(part)
        self._count("psum_scatter", out, n)
        return out

    def _all_to_all(self, x, axes: Axes, split_axis: int, concat_axis: int):
        names = _axes_tuple(axes)
        grp, pg, lin, at = self._layout(names)
        n = len(grp)
        if x.shape[split_axis] % n:
            raise ValueError(
                f"all_to_all: split axis {split_axis} of length "
                f"{x.shape[split_axis]} does not divide over {n}")
        if n == 1:
            out = x.clone()
        else:
            self._check("all_to_all", names, x, pg, grp)
            send, part = self._split_send(x, split_axis, n, lin)
            got = self._all_to_all_flat(send, pg).view(n, -1)
            out = torch.cat([got[at[j]].view(part) for j in range(n)],
                            concat_axis)
        self._count("all_to_all", out, n)
        return out

    def _extreme(self, op: str, x, axes: Axes, pick):
        if self._tracked(x):
            raise ValueError(
                f"{op} carries no gradient: detach its input (the JAX "
                "stop_gradient) instead of dropping the gradient silently")
        names = _axes_tuple(axes)
        grp, pg, _, at = self._layout(names)
        n = len(grp)
        if n == 1:
            out = x.clone()
        else:
            self._check(op, names, x, pg, grp)
            rows = self._gather_flat(x, pg, n).view(n, *x.shape)
            out = rows[at[0]]
            for j in range(1, n):
                out = pick(out, rows[at[j]])
            out = out.clone()
        self._count(op, out, n)
        return out

    def _permute(self, x, axes: Axes, perm):
        """Post this rank's send and receive of a permute: (the works,
        a function giving the result once they are done)."""
        import torch.distributed as dist

        names = _axes_tuple(axes)
        grp, pg, _, _ = self._layout(names)
        n, i = len(grp), grp.index(self.rank)
        if n > 1:
            self._check("ppermute", names, x, pg, grp)
        src = [s for s, d in perm if d == i]
        ops, recv = [], None
        if src and src[0] != i:
            recv = self._empty_wire(x.numel() * x.element_size(), x)
            ops.append(dist.P2POp(dist.irecv, recv, grp[src[0]]))
        dsts = [d for s, d in perm if s == i and d != i]
        if dsts:
            send = self._wire(x)
            ops += [dist.P2POp(dist.isend, send, grp[d]) for d in dsts]
        works = dist.batch_isend_irecv(ops) if ops else []
        self._count("ppermute", x, n)

        def finish():
            if not src:
                return torch.zeros_like(x)
            if src[0] == i:
                return x.clone()
            return self._unwire(recv, x).view(x.shape)
        return works, finish

    def _ppermute(self, x, axes: Axes, perm):
        works, finish = self._permute(x, axes, perm)
        for work in works:
            work.wait()
        self._log_pair()
        return finish()

    def _ppermute_start(self, x, axes: Axes, perm):
        """Post the permute (module doc, and the class doc's split-phase
        note); the start and the handle's wait go into ``issue_log``."""
        works, finish = self._permute(x, axes, perm)
        key = (self._transfers, self.ledger.phase)
        self._transfers += 1
        self.issue_log.append(("start",) + key)
        if self.backend == "nccl":
            return _PendingTransfer(works, finish, self.issue_log, key)
        for work in works:
            work.wait()
        return _Transfer(finish(), None, self.issue_log, key)

    # ---- off the ledger: checkpoint assembly, agreement -------------------
    def send_recv(self, sends, recvs) -> List[torch.Tensor]:
        """Point-to-point transfers that are not the model's collectives
        (checkpoint assembly; not in the ledger): ``sends`` are (rank,
        tensor) pairs, ``recvs`` (rank, like) pairs; returns a tensor
        shaped, typed and placed like each ``like``."""
        import torch.distributed as dist

        ops, bufs = [], []
        for src, like in recvs:
            bufs.append(self._empty_wire(like.numel() * like.element_size(),
                                         like))
            ops.append(dist.P2POp(dist.irecv, bufs[-1], src))
        for dst, t in sends:
            ops.append(dist.P2POp(dist.isend, self._wire(t), dst))
        for work in (dist.batch_isend_irecv(ops) if ops else []):
            work.wait()
        return [self._unwire(buf, like).view(like.shape)
                for buf, (_, like) in zip(bufs, recvs)]

    def agree(self, value: int) -> List[int]:
        """Every rank's ``value``, in rank order (not in the ledger)."""
        mine = torch.tensor([value], dtype=torch.int64,
                            device=self.wire_device)
        out = torch.empty(self.size, dtype=torch.int64,
                          device=self.wire_device)
        self._gather_into(out, mine)
        return out.tolist()
