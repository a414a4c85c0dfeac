"""The engine-API boundary between the orchestrator and its worker
replicas (the port of ``repro.frontend.protocol``).

Plain-data messages a ``multiprocessing`` pipe can carry, plus the packed
step result. Four calls cross the pipe in the hot path:

  ``add(rid, request)``   -> None | rejection dict
  ``step()``              -> packed StepResult (one host array)
  ``preempt(rid)``        -> resume-request dict | None
  ``flush()``             -> commit staged host-tier spills

and a cold-path tail (``metrics`` / ``trace`` / ``digest`` /
``shutdown``) for observability and drain. A step's emissions ride in one
``(k, 2) int32`` host array, one pickle of one numpy buffer a step rather
than one message a token, with the slot counts beside it so the
orchestrator routes and preempts without further calls.

Requests cross as ``dataclasses.asdict`` dicts of
``repro_torch.engine.Request`` keyed by an orchestrator-assigned integer
``rid`` (the uid is ``r<rid>``), so the packed array needs no strings.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def uid_for(rid: int) -> str:
    return f"r{rid}"


def rid_for(uid: str) -> int:
    return int(uid[1:])


def request_to_wire(req) -> Dict[str, Any]:
    return dataclasses.asdict(req)


def request_from_wire(d: Dict[str, Any]):
    from repro_torch.engine import Request

    return Request(**d)


def rejection_to_wire(rej) -> Dict[str, Any]:
    return dataclasses.asdict(rej)


def rejection_from_wire(d: Dict[str, Any]):
    from repro_torch.engine import Rejection

    return Rejection(**d)


@dataclasses.dataclass
class StepResult:
    """One worker step's emissions and its scheduler's occupancy."""

    tokens: np.ndarray            # (k, 2) int32: [rid, token] per emission
    finished: List[int]           # rids that completed this step
    free_slots: int               # open decode slots after this step
    queued: int                   # requests still waiting for a slot
    active: int                   # slots holding live requests
    outstanding_tokens: int       # queued + remaining decode budget

    @property
    def emitted(self) -> List[Tuple[int, int]]:
        return [(int(r), int(t)) for r, t in self.tokens]


def pack_step(emitted: List[Tuple[int, int]], finished: List[int], *,
              free_slots: int, queued: int, active: int,
              outstanding_tokens: int) -> StepResult:
    arr = np.asarray(emitted, np.int32).reshape(-1, 2) if emitted \
        else np.zeros((0, 2), np.int32)
    return StepResult(tokens=arr, finished=list(finished),
                      free_slots=int(free_slots), queued=int(queued),
                      active=int(active),
                      outstanding_tokens=int(outstanding_tokens))


def make_worker_spec(*, plan, eng=None, arch: Optional[str] = None,
                     init_seed: int = 0, trace: bool = False,
                     prefill_chunk: int = 0, smoke: bool = True,
                     device: Optional[str] = None) -> Dict[str, Any]:
    """Everything a worker needs to build its engine, as one picklable
    (and JSON-able) dict. The plan rides as its ``to_dict`` form; weights
    are not shipped: every worker draws them from ``init_seed`` on its
    device (``factory.build_model``), which gives the same bits in every
    process. ``smoke`` picks the arch's smoke config (the JAX worker's
    outcome for its local plans, which the port's always are) or the full
    one; ``device`` is the worker's (None: the CUDA card, raising if there
    is none)."""
    spec: Dict[str, Any] = {
        "plan": plan.to_dict(),
        "init_seed": int(init_seed),
        "trace": bool(trace),
        "prefill_chunk": int(prefill_chunk),
        "n_devices": int(plan.n_devices),
        "smoke": bool(smoke),
        "device": None if device is None else str(device),
    }
    if arch is not None:
        spec["arch"] = arch
    if eng is not None:
        spec["eng"] = dataclasses.asdict(eng)
    return spec


class ReplicaDead(RuntimeError):
    """The worker process behind a replica client is gone (EOF or a broken
    pipe mid-call). The orchestrator marks the replica dead in the router
    and re-admits its streams in flight elsewhere."""

    def __init__(self, index: int, detail: str = ""):
        super().__init__(f"replica {index} died{': ' if detail else ''}"
                         f"{detail}")
        self.index = index
