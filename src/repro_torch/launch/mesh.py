"""Legal mesh shapes (the port's copy of ``refinable_grids`` from
``repro.launch.mesh``).

The port's ranks are ``dist.comm.ThreadMesh`` threads on one device, or
processes with a ``dist.comm.ProcessComm`` each (``dist.procs``), whose
(data, model) split ``dist.elastic.plan_mesh`` fits to the ranks there
are. The JAX package's production mesh (``make_production_mesh``: a (16,
16) data x model grid of cards) is not ported (ROADMAP.md §A item 1 d).
"""

from __future__ import annotations

from typing import List, Tuple


def refinable_grids(n_devices: int) -> List[Tuple[int, int]]:
    """Legal (data, model) grids for `n_devices`: model must admit a C >= 2
    StarTrail refinement (model % 4 == 0, so (C=2, R=model/4) exists)."""
    out = []
    for model in range(4, n_devices + 1, 4):
        if n_devices % model == 0:
            out.append((n_devices // model, model))
    return out
