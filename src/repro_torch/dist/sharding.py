"""Mesh axis names (the port's copy of ``SP_AXES`` from
``repro.dist.sharding``, and the data axis of its test meshes).

The joint sequence-parallel axes, major-to-minor. Sharding one dimension
over them linearises the coordinates (g, j, t) as rank p = (g*R + j)*C + t,
exactly ``core.topology.StarTrailTopology.rank`` and ``Runtime.sp_rank()``.
A mesh with data-parallel replicas puts ``DATA_AXIS`` before them, as
``repro.dist.meshes.local_mesh_for_tests`` does: ``MESH_AXES``. The port
stores parameters whole (no FSDP shards), so the rule sets of the JAX
module are not carried over.
"""

from typing import Tuple

SP_AXES: Tuple[str, str, str] = ("sp_grp", "sp_ring", "sp_team")
DATA_AXIS = "data"
MESH_AXES: Tuple[str, str, str, str] = (DATA_AXIS,) + SP_AXES
