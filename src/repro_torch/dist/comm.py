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

Three implementations:

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

The multi-process NCCL/gloo implementation, for ranks on several cards,
waits for a cell with more than one card (ROADMAP.md, the main path).
"""

from __future__ import annotations

import contextlib
import threading
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
        self.reset()

    def reset(self) -> None:
        self.bytes = {ph: dict.fromkeys(WIRE_KINDS, 0) for ph in PASSES}
        self.calls = {ph: dict.fromkeys(WIRE_KINDS, 0) for ph in PASSES}

    def add(self, kind: str, nbytes: int) -> None:
        self.bytes[self.phase][kind] += nbytes
        self.calls[self.phase][kind] += 1

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
        grid = refine_grid(np.arange(self.sp_size), c, placement)
        sp_coords = {int(grid[g, j, t]): (g, j, t)
                     for g in range(c) for j in range(r) for t in range(c)}
        self._coords = [dict(zip(MESH_AXES, (d,) + sp_coords[q]))
                        for d in range(data) for q in range(self.sp_size)]
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
