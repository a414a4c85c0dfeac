"""Atomic, optionally asynchronous checkpoints of parameter and optimizer
trees (the port's counterpart of ``repro.dist.checkpoint``), in the JAX
package's on-disk format, so a checkpoint written by either package
restores in the other:

    <ckpt_dir>/
      step_00000007/            # one completed checkpoint per step
        manifest.json           # {"step": 7, "leaves": [{file, shape, dtype}]}
        leaf_00000.bin          # raw bytes of each tree leaf, flatten order
        ...

A tree is nested dicts (flattened in sorted-key order, as ``jax.tree``
flattens a dict), lists or tuples (in order) and leaves: tensors, numpy
arrays or Python scalars. Dtypes are written as numpy's names
(``"bfloat16"`` for bf16); the bytes go through torch, so no bf16 support
in numpy is needed. Writers stage into ``step_XXXXXXXX.tmp`` and
``os.replace`` it to the final name, so a checkpoint directory exists iff
it is complete: a crashed writer's ``.tmp`` is invisible to
``completed_steps`` and overwritten by the next attempt.

``save(..., blocking=False)`` copies the tree to host memory in the
caller's thread and returns a started writer thread doing the disk I/O; it
re-raises a failure at ``join()``. Join it before the next save to the
same directory (``train/trainer.py`` does).

Rank processes (``dist.comm.ProcessComm``) hold shards, and a checkpoint
holds whole leaves, so one written under any mesh restores under any
other: ``gather_leaves`` sends each leaf's unique shards from their owners
to rank 0, which writes them; a restoring rank reads the whole leaves and
keeps its blocks. ``agreed_step`` makes every rank restore the same step.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import threading
from typing import List, Optional, Union

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d{8,})$")  # 8+: {:08d} grows past 1e8 steps

# numpy dtype name <-> torch dtype of the leaves a training checkpoint
# holds: parameters and moments in a float type, the step in int32
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "int32": torch.int32}
_NAMES = {v: k for k, v in DTYPES.items()}


class _Writer(threading.Thread):
    """Daemon checkpoint writer that re-raises its failure at ``join()``
    (a silently dead writer would let training go on without checkpoints
    and a later restart resume from a stale step)."""

    def __init__(self, fn, name: str):
        super().__init__(name=name, daemon=True)
        self._fn = fn
        self.exc: Optional[BaseException] = None

    def run(self):
        try:
            self._fn()
        except BaseException as e:  # noqa: BLE001 (re-raised at join)
            self.exc = e

    def join(self, timeout=None):
        super().join(timeout)
        if self.exc is not None:
            raise self.exc


def leaves(tree) -> list:
    """The leaves of ``tree`` in the JAX flatten order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def _unflatten(tree, it):
    if isinstance(tree, dict):
        out = {k: _unflatten(tree[k], it) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(t, it) for t in tree)
    return next(it)


def _host_copy(leaf) -> torch.Tensor:
    """A CPU tensor holding its own copy of ``leaf``'s values."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).contiguous()
    return torch.from_numpy(np.array(leaf, copy=True))


def _step_dir(root: Union[str, pathlib.Path], step: int) -> pathlib.Path:
    return pathlib.Path(root) / f"step_{step:08d}"


def save(ckpt_dir: Union[str, pathlib.Path], step: int, tree, *,
         blocking: bool = True) -> Optional[threading.Thread]:
    """Write ``tree`` as checkpoint ``step``. Returns None (blocking) or the
    started writer thread (``blocking=False``)."""
    arrays = [_host_copy(x) for x in leaves(tree)]   # device -> host
    for a in arrays:
        if a.dtype not in _NAMES:
            raise TypeError(f"checkpoint leaf dtype {a.dtype} not in "
                            f"{sorted(DTYPES)}")
    root = pathlib.Path(ckpt_dir)
    root.mkdir(parents=True, exist_ok=True)
    final = _step_dir(root, step)
    tmp = final.with_name(final.name + ".tmp")

    def _write():
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest: List[dict] = []
        for i, arr in enumerate(arrays):
            fname = f"leaf_{i:05d}.bin"
            (tmp / fname).write_bytes(
                arr.reshape(-1).view(torch.uint8).numpy())
            manifest.append({"file": fname, "shape": list(arr.shape),
                             "dtype": _NAMES[arr.dtype]})
        (tmp / "manifest.json").write_text(
            json.dumps({"step": step, "leaves": manifest}, indent=1))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)

    if blocking:
        _write()
        return None
    t = _Writer(_write, name=f"ckpt-save-{step}")
    t.start()
    return t


def restore(ckpt_dir: Union[str, pathlib.Path], step: int, tree_like):
    """Read checkpoint ``step`` into the structure of ``tree_like``, whose
    leaves (anything with ``shape`` and ``dtype``) are checked against the
    manifest. Returns the tree with CPU tensors as leaves."""
    final = _step_dir(ckpt_dir, step)
    manifest = json.loads((final / "manifest.json").read_text())
    refs = leaves(tree_like)
    entries = manifest["leaves"]
    if len(entries) != len(refs):
        raise ValueError(
            f"checkpoint {final} has {len(entries)} leaves but the reference "
            f"tree has {len(refs)}")
    out = []
    for ref, ent in zip(refs, entries):
        if ent["dtype"] not in DTYPES:
            raise TypeError(f"checkpoint leaf {ent['file']} dtype "
                            f"{ent['dtype']} not in {sorted(DTYPES)}")
        dtype = DTYPES[ent["dtype"]]
        shape = tuple(ent["shape"])
        if tuple(ref.shape) != shape:
            raise ValueError(
                f"checkpoint leaf {ent['file']} shape {shape} != reference "
                f"{tuple(ref.shape)}")
        ref_dtype = ref.dtype if isinstance(ref, torch.Tensor) \
            else DTYPES.get(str(ref.dtype))
        if ref_dtype != dtype:
            raise ValueError(
                f"checkpoint leaf {ent['file']} dtype {ent['dtype']} != "
                f"reference {ref.dtype} (did param_dtype change between "
                f"runs?)")
        data = bytearray((final / ent["file"]).read_bytes())
        out.append(torch.frombuffer(data, dtype=dtype).reshape(shape)
                   if data else torch.empty(shape, dtype=dtype))
    return _unflatten(tree_like, iter(out))


def completed_steps(ckpt_dir: Union[str, pathlib.Path]) -> set:
    """All fully committed checkpoint steps in ``ckpt_dir``: only
    ``step_XXXXXXXX`` directories count, never ``.tmp`` staging ones."""
    root = pathlib.Path(ckpt_dir)
    if not root.is_dir():
        return set()
    steps = set()
    for child in root.iterdir():
        m = _STEP_RE.match(child.name)
        if m and child.is_dir():
            steps.add(int(m.group(1)))
    return steps


def latest_common_step(*ckpt_dirs: Union[str, pathlib.Path]
                       ) -> Optional[int]:
    """Highest step completed in *every* given directory (None if there is
    none). A crash between the writes of two trees (parameters and
    optimizer) leaves them apart, and the newest step present in all of
    them is the restore point; the step sets are intersected, since
    restarts with other cadences can leave them further apart."""
    common = None
    for d in ckpt_dirs:
        steps = completed_steps(d)
        common = steps if common is None else common & steps
    return max(common) if common else None


def latest_step(ckpt_dir: Union[str, pathlib.Path]) -> Optional[int]:
    """Highest completed checkpoint step in ``ckpt_dir`` (None if empty)."""
    steps = completed_steps(ckpt_dir)
    return max(steps) if steps else None


def gather_leaves(comm, tensors, names, layouts, shapes
                  ) -> Optional[List[torch.Tensor]]:
    """The whole leaves, on rank 0 as CPU tensors (None on the other
    ranks), from the shards ``tensors`` (named ``names``, stored under
    ``layouts``, of whole shapes ``shapes``) that every rank of the
    ``ProcessComm`` ``comm`` holds: each unique shard crosses once, from
    its owner (``dist.sharding.owns``; rank 0 owns every shard it
    holds)."""
    from repro_torch.dist import sharding

    points = [sharding.MeshPoint(comm.shape, comm.coords(q))
              for q in range(comm.size)]
    out = [] if comm.rank == 0 else None
    for name, t in zip(names, tensors):
        owners = [q for q in range(1, comm.size)
                  if sharding.owns(layouts[name], points[q])]
        if comm.rank == 0:
            whole = torch.empty(shapes[name], dtype=t.dtype)
            blocks = [sharding.shard_slices(shapes[name], layouts[name],
                                            points[q], name)
                      for q in [0] + owners]
            got = comm.send_recv([], [(q, torch.empty(
                whole[b].shape, dtype=t.dtype, device=comm.wire_device))
                for q, b in zip(owners, blocks[1:])])
            for b, g in zip(blocks, [t] + got):
                whole[b] = g.cpu()
            out.append(whole)
        elif comm.rank in owners:
            comm.send_recv([(0, t)], [])
    return out


def agreed_step(comm, *ckpt_dirs) -> Optional[int]:
    """``latest_common_step`` of ``ckpt_dirs`` as every rank of ``comm``
    sees it; ranks that see different steps (a checkpoint directory not
    shared by every rank) raise."""
    last = latest_common_step(*ckpt_dirs)
    seen = comm.agree(-1 if last is None else last)
    if len(set(seen)) > 1:
        raise RuntimeError(
            f"ranks see different checkpoint steps {seen} in "
            f"{[str(d) for d in ckpt_dirs]}: every rank must read the "
            "directory rank 0 writes")
    return last
