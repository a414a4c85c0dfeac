"""Ranks as processes: the launcher of a ``dist.comm.ProcessComm`` mesh.

``ProcessMesh(c, r, data, placement, backend, device)`` stands where a
``dist.comm.ThreadMesh`` stands: ``run(fn, *args)`` calls ``fn(comm,
*args)`` once per rank, each with its own ``ProcessComm``, and returns the
results in rank order. The ranks are processes:

  * **Spawned.** With no ``RANK``/``WORLD_SIZE`` in the environment, ``run``
    starts ``data*c*c*r`` processes with the ``spawn`` start method (a CUDA
    context does not survive a fork). They meet at a ``FileStore`` in a
    temporary directory of their own, so concurrent runs never race for a
    TCP port. ``fn`` and ``args`` go to the children pickled in a file
    there: ``fn`` must be a module-level function of a module the
    children can import, and its results come back through files in that
    directory (``torch.save``; tensors return on the CPU).
  * **Joined.** Under ``torchrun`` (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT`` set) this process is
    one rank: ``run`` joins the group and returns ``[fn(comm, *args)]``,
    this rank's result alone (a group it made is destroyed after ``fn``). A rank at or above the mesh's size is
    stranded (``dist.elastic.plan_mesh`` planned fewer ranks than were
    started): it joins nothing and returns ``[]``.

Rank ``i`` runs on ``cuda:{local_rank % device_count}`` (``torch.cuda.
set_device``) unless the mesh is given ``device='cpu'``; under ``nccl``
each rank needs a card of its own, and a mesh of more ranks than cards
raises before anything starts (``ProcessComm`` checks it again across
hosts). Each child takes an equal share of the host's cores for torch's
intra-op threads.

A rank that raises writes its exception and traceback, and exits non-zero;
the launcher then terminates every other rank, and re-raises the first
failing rank's exception with its traceback as a note. Each collective
times out after the mesh's ``timeout`` seconds (the process groups'), and
a run longer than ``run``'s ``timeout`` is terminated the same way and
raises ``TimeoutError``. Every process a run starts has ended when ``run``
returns or raises.

``fit_mesh(devices, data)`` is the launchers' (``launch.train`` and
``launch.serve`` with ``--backend gloo|nccl``) ``dist.elastic.plan_mesh``
over the ranks there are: ``WORLD_SIZE`` under ``torchrun``, else the
ranks asked for.

This module and what its children import hold no JAX: the children import
``torch``, this package and ``fn``'s module.
"""

from __future__ import annotations

import datetime
import os
import pathlib
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional

import torch

from repro_torch.dist.comm import ProcessComm
from repro_torch.dist.elastic import MeshPlan, plan_mesh

BACKENDS = ("gloo", "nccl")


def joined() -> bool:
    """Whether this process was started as one rank (``torchrun``)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def fit_mesh(devices: int, data: int = 1) -> MeshPlan:
    """``plan_mesh`` of a launch that asked for ``devices`` ranks in
    ``data`` replicas: over ``WORLD_SIZE`` ranks under ``torchrun`` (the
    ranks it started), else over ``devices``, keeping the model axis at
    ``devices // data`` where they fit. The launch runs ``devices`` ranks
    in ``data`` replicas of the result; the rest are stranded."""
    world = int(os.environ["WORLD_SIZE"]) if joined() else devices
    target = max(devices // data, 1)
    return plan_mesh(world, model_axis_target=target,
                     min_model=min(4, target))


def _rank_device(device: Optional[str], local_rank: int) -> torch.device:
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("ProcessMesh runs its ranks on CUDA cards by "
                           "default and none is available; pass "
                           "device='cpu' to run them on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def _threads_per_rank(nprocs: int) -> int:
    return max(1, len(os.sched_getaffinity(0)) // nprocs)


def _init(backend: str, rank: int, world: int, device: torch.device,
          init_method: str, timeout: float) -> None:
    import torch.distributed as dist

    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))


def _child(rank: int, world: int, local_rank: int, mesh: dict,
           workdir: str, timeout: float) -> None:
    """One spawned rank: join the group, run the call ``workdir`` holds,
    save its result (or its exception) under ``workdir``."""
    import torch.distributed as dist

    out = pathlib.Path(workdir)
    try:
        # the call comes from a file, not the spawn pipe: a large argument
        # there would hold each start until the child before had read it
        fn, args = pickle.loads((out / "call.pkl").read_bytes())
        torch.set_num_threads(_threads_per_rank(world))
        device = _rank_device(mesh["device"], local_rank)
        _init(mesh["backend"], rank, world, device,
              f"file://{out / 'store'}", timeout)
        comm = ProcessComm(mesh["c"], mesh["r"], mesh["data"],
                           mesh["placement"], timeout=timeout)
        result = fn(comm, *args)
        tmp = out / f"result_{rank}.tmp"
        torch.save(result, tmp)
        os.replace(tmp, out / f"result_{rank}.pt")
        dist.destroy_process_group()
    except BaseException as e:  # noqa: BLE001 (the launcher re-raises it)
        text = traceback.format_exc()
        try:
            payload = pickle.dumps((time.time(), e, text))
        except Exception:  # noqa: BLE001 (an exception that will not pickle)
            payload = pickle.dumps((time.time(), RuntimeError(repr(e)), text))
        tmp = out / f"error_{rank}.tmp"
        tmp.write_bytes(payload)
        os.replace(tmp, out / f"error_{rank}.pkl")
        os._exit(1)


class ProcessMesh:
    """``data*c*c*r`` ranks as processes over ``backend`` (module doc)."""

    def __init__(self, c: int, r: int, data: int = 1,
                 placement: str = "team_inner", backend: str = "gloo",
                 device: Optional[str] = None, timeout: float = 600.0):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{backend!r}")
        if device not in (None, "cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got "
                             f"{device!r}")
        if backend == "nccl" and device == "cpu":
            raise ValueError("nccl runs on CUDA cards: use gloo on the CPU")
        self.c, self.r, self.data = c, r, data
        self.placement, self.backend, self.device = placement, backend, device
        self.size = data * c * c * r
        self.timeout = timeout        # each collective's (process groups)

    def _check_cards(self) -> None:
        if self.backend != "nccl":
            return
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < self.size:
            raise RuntimeError(
                f"nccl takes one rank per card: {self.size} ranks, {cards} "
                "cards on this host; run several ranks on one card with "
                "backend='gloo'")

    def run(self, fn: Callable, *args,
            timeout: Optional[float] = None) -> List:
        """``fn(comm, *args)`` on every rank (module doc); ``timeout``
        bounds the whole run when spawned (default: none, each collective
        still times out after the mesh's ``timeout``)."""
        mesh = dict(c=self.c, r=self.r, data=self.data,
                    placement=self.placement, backend=self.backend,
                    device=self.device)
        if joined():
            return self._join(fn, args)
        self._check_cards()
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        workdir = tempfile.mkdtemp(prefix="repro_torch_procs_")
        procs = []
        try:
            (pathlib.Path(workdir) / "call.pkl").write_bytes(
                pickle.dumps((fn, args)))
            for rank in range(self.size):
                p = ctx.Process(target=_child, name=f"procs-rank{rank}",
                                args=(rank, self.size, rank, mesh, workdir,
                                      self.timeout))
                p.start()
                procs.append(p)
            self._wait(procs, pathlib.Path(workdir), timeout)
            return [torch.load(pathlib.Path(workdir) / f"result_{i}.pt",
                               map_location="cpu", weights_only=False)
                    for i in range(self.size)]
        finally:
            _stop(procs)
            shutil.rmtree(workdir, ignore_errors=True)

    def _join(self, fn, args) -> List:
        import torch.distributed as dist

        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if world < self.size:
            raise ValueError(f"the mesh has {self.size} ranks, the job "
                             f"{world}")
        if rank >= self.size:
            return []
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        if self.backend == "nccl" and torch.cuda.device_count() <= local_rank:
            raise RuntimeError(
                f"nccl takes one rank per card: local rank {local_rank}, "
                f"{torch.cuda.device_count()} cards on this host")
        device = _rank_device(self.device, local_rank)
        made = not dist.is_initialized()
        if made:
            _init(self.backend, rank, self.size, device, "env://",
                  self.timeout)
        comm = ProcessComm(self.c, self.r, self.data, self.placement,
                           timeout=self.timeout)
        out = [fn(comm, *args)]
        if made:                   # as a spawned rank's, once fn is done
            dist.destroy_process_group()
        return out

    @staticmethod
    def _wait(procs, workdir: pathlib.Path,
              timeout: Optional[float]) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            errors = sorted(workdir.glob("error_*.pkl"))
            failed = [p for p in procs
                      if p.exitcode is not None and p.exitcode != 0]
            if errors or failed:
                _stop(procs)
                raise _root_error(workdir, procs)
            if all(p.exitcode == 0 for p in procs):
                return
            if deadline is not None and time.monotonic() > deadline:
                _stop(procs)
                raise TimeoutError(f"ProcessMesh run exceeded {timeout} s")
            for p in procs:
                p.join(0.05)


def _stop(procs, grace: float = 5.0) -> None:
    """Terminate every live process, then kill any left after ``grace``."""
    for p in procs:
        if p.is_alive():
            p.terminate()
    end = time.monotonic() + grace
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join()


def _root_error(workdir: pathlib.Path, procs) -> BaseException:
    """The first error a rank wrote (the others' follow from it), or an
    error naming the ranks that died without writing one."""
    found = []
    for path in workdir.glob("error_*.pkl"):
        stamp, exc, text = pickle.loads(path.read_bytes())
        found.append((stamp, int(path.stem.split("_")[1]), exc, text))
    if not found:
        codes = {i: p.exitcode for i, p in enumerate(procs)
                 if p.exitcode not in (None, 0)}
        return RuntimeError(f"ProcessMesh ranks died without an error: "
                            f"exit codes {codes}")
    _, rank, exc, text = min(found, key=lambda f: f[0])
    exc.add_note(f"raised on rank {rank} of the ProcessMesh:\n{text}")
    return exc
