"""Refine a flat SP degree into the concentric axes (the port's copy of the
numpy part of ``repro.dist.meshes``).

StarTrail factors P sequence-parallel ranks into three axes

    (sp_grp = C, sp_ring = R, sp_team = C)      with  P = C^2 * R

matching ``core/topology.py``: rank (g, j, t) has team ``g*R + j`` and
global SP rank ``p = g*R*C + j*C + t``. ``placement`` decides which SP axis
lands on the innermost (adjacent) members of the flat axis, the scheduler's
two options (paper §3.4):

  * ``"team_inner"``  (Collect_intra): the flat axis splits ``(g, j, t)``
    with ``t`` fastest-varying, so the team collectives get the short hops;
  * ``"ring_inner"``  (P2P_intra): the flat axis splits ``(g, t, j)`` with
    ``j`` fastest-varying, presented as ``(g, j, t)``, so the ring permutes
    get the short hops.

``dist.comm.ThreadMesh`` maps its threads, and ``dist.comm.ProcessComm``
its processes, to coordinates through ``refine_grid``. Refining a JAX
device mesh (``refine_mesh``) is not ported (ROADMAP.md §A item 1 d).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

PLACEMENTS: Tuple[str, str] = ("team_inner", "ring_inner")


def _validate_factorisation(p: int, c: int) -> int:
    """Returns R; raises if (P, C) is not a valid StarTrail factorisation."""
    if c < 1:
        raise ValueError(f"C must be >= 1, got {c}")
    if c * c > p or p % (c * c) != 0:
        raise ValueError(
            f"C={c} invalid for P={p}: need C <= sqrt(P)="
            f"{math.isqrt(p)} and P % C^2 == 0")
    return p // (c * c)


def refine_grid(grid: np.ndarray, c: int, placement: str = "team_inner"
                ) -> np.ndarray:
    """Factor the last (flat SP) dim of ``grid`` into (C, R, C):
    output[..., g, j, t] == input[..., rank] with ``rank`` as defined by
    ``core.topology.StarTrailTopology.rank(g, j, t)`` for ``team_inner``."""
    p = grid.shape[-1]
    r = _validate_factorisation(p, c)
    lead = grid.shape[:-1]
    if placement == "team_inner":
        return grid.reshape(lead + (c, r, c))
    if placement == "ring_inner":
        # innermost members traverse the ring: split (g, t, j), present as
        # (g, j, t)
        return np.swapaxes(grid.reshape(lead + (c, c, r)), -1, -2)
    raise ValueError(f"placement must be one of {PLACEMENTS}, got "
                     f"{placement!r}")
