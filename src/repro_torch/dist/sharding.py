"""Sequence-parallel axis names (the port's copy of ``SP_AXES`` from
``repro.dist.sharding``).

The joint sequence-parallel axes, major-to-minor. Sharding one dimension
over them linearises the coordinates (g, j, t) as rank p = (g*R + j)*C + t,
exactly ``core.topology.StarTrailTopology.rank`` and ``Runtime.sp_rank()``.
The port stores parameters whole (no FSDP shards), so the rule sets of the
JAX module are not carried over.
"""

from typing import Tuple

SP_AXES: Tuple[str, str, str] = ("sp_grp", "sp_ring", "sp_team")
