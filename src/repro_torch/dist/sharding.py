"""Logical-axis -> mesh-axis sharding rules and per-rank parameter layouts
(the port's counterpart of ``repro.dist.sharding``; its rule tables are a
copy of the JAX module's).

Parameters declare *logical* axis names in their ``PSpec`` (``"embed"``,
``"ffn"``, ``"vocab"``, ...). A *rule set* maps each logical axis to the
tuple of mesh axes it is stored sharded over; unnamed axes are replicated.
``spec_for_axes`` turns one leaf's logical axes into its *layout*: a tuple
with, per dimension, the mesh axes that dimension is split over, major to
minor (``()`` for a replicated dimension), the entries of the JAX
``PartitionSpec``. ``partition_tree`` maps a tree of logical axes.

Each rank of a ``dist.comm.ThreadMesh`` stores its shard of every leaf: a
dimension split over mesh axes ``(a, b, ...)`` is cut into
``size(a) * size(b) * ...`` equal blocks, and the rank holds the block at
its linear index over those axes (``shard_slices``). On one card the
shards are views of the ``Model``'s whole tensors (``models.factory.
shard_params``), so the ranks' shards together are exactly the whole leaf.
A rank process (``dist.comm.ProcessComm``) holds its shards alone, each an
allocation of its own (``models.factory.rank_model``). At P = 1 every
shard is the whole leaf.

Two kinds of sharded storage coexist (see ``models/runtime.py:dense``):

  * **computation-sharded** axes stay sharded through the matmul and the
    surrounding code supplies the collectives (``"vocab"`` vocab-parallel
    loss, ``"ffn"`` TP with activation gather/reduce-scatter in the
    ``default`` rules, ``"expert_ffn"`` and ``"experts"`` for the MoE
    block, which is not ported yet).
  * **FSDP** axes (listed by :func:`fsdp_logical`) are storage-only:
    ``Runtime.dense`` all-gathers them on use and the gather's transpose
    reduce-scatters the gradient (ZeRO-3).

Rule sets:

  ``default`` -- FSDP over ``data`` for embed dims; tensor-parallel MLP
      (``ffn`` stays sharded over the SP axes, activations gathered);
      vocab-parallel embedding/loss over the SP axes.
  ``fsdp``    -- like ``default`` but the MLP ``ffn`` dim is gathered on use
      instead of the activations (no activation collectives).
  ``tp``      -- ``fsdp`` plus attention ``heads`` stored sharded over the
      innermost team axis (gathered on use). KV heads stay replicated so
      GQA archs with few KV heads remain layout-legal.

The joint sequence-parallel axes ``SP_AXES`` run major-to-minor: sharding
one dimension over them linearises the coordinates (g, j, t) as rank
p = (g*R + j)*C + t, exactly ``core.topology.StarTrailTopology.rank`` and
``Runtime.sp_rank()``. A mesh with data-parallel replicas puts
``DATA_AXIS`` before them (``MESH_AXES``), as
``repro.dist.meshes.local_mesh_for_tests`` does.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Optional, Tuple, Union

SP_AXES: Tuple[str, str, str] = ("sp_grp", "sp_ring", "sp_team")
DATA_AXIS = "data"
MESH_AXES: Tuple[str, str, str, str] = (DATA_AXIS,) + SP_AXES

Rules = Dict[str, Tuple[str, ...]]
# per dimension, the mesh axes it is split over (major to minor)
Layout = Tuple[Tuple[str, ...], ...]

RULES: Dict[str, Rules] = {
    "default": {
        "embed": ("data",),
        "embed_out": ("data",),
        "vocab": SP_AXES,
        "ffn": SP_AXES,
        "experts": ("data",),
        "expert_ffn": SP_AXES,
    },
    "fsdp": {
        "embed": ("data",),
        "embed_out": ("data",),
        "vocab": SP_AXES,
        "ffn": SP_AXES,
        "experts": ("data",),
        "expert_ffn": SP_AXES,
    },
    "tp": {
        "embed": ("data",),
        "embed_out": ("data",),
        "vocab": SP_AXES,
        "ffn": SP_AXES,
        "experts": ("data",),
        "expert_ffn": SP_AXES,
        "heads": ("sp_team",),
    },
}

# Logical axes whose shards are *gathered on use* by ``Runtime.dense``;
# everything else in a rule set stays sharded through the computation.
_FSDP_LOGICAL: Dict[str, FrozenSet[str]] = {
    "default": frozenset({"embed", "embed_out"}),
    "fsdp": frozenset({"embed", "embed_out", "ffn"}),
    "tp": frozenset({"embed", "embed_out", "ffn", "heads"}),
}


def check_rules(rules: str) -> str:
    if rules not in RULES:
        raise ValueError(f"sharding_rules must be one of {sorted(RULES)}, "
                         f"got {rules!r}")
    return rules


def fsdp_logical(rules: str = "default") -> FrozenSet[str]:
    """The gather-on-use logical axes of a rule set (see module doc)."""
    return _FSDP_LOGICAL[rules]


def spec_for_axes(axes: Tuple[Optional[str], ...],
                  rules: Union[str, Rules] = "default") -> Layout:
    """One leaf's layout from its logical ``axes`` tuple; a rule set that
    maps two of its dims onto one mesh axis raises ``ValueError``."""
    table = RULES[rules] if isinstance(rules, str) else rules
    entries = []
    used = set()
    for ax in axes:
        mesh_axes = table.get(ax) if ax is not None else None
        if not mesh_axes:
            entries.append(())
            continue
        dup = used.intersection(mesh_axes)
        if dup:
            raise ValueError(
                f"rule set maps {axes} onto mesh axis {sorted(dup)} twice")
        used.update(mesh_axes)
        entries.append(tuple(mesh_axes))
    return tuple(entries)


def partition_tree(axes_tree, rules: Union[str, Rules] = "default"):
    """Map a tree of logical-axis tuples (nested dicts and lists, as
    ``models.spec.axes_tree`` makes it) to the tree of their layouts."""
    if isinstance(axes_tree, dict):
        return {k: partition_tree(v, rules) for k, v in axes_tree.items()}
    if isinstance(axes_tree, list):
        return [partition_tree(v, rules) for v in axes_tree]
    return spec_for_axes(axes_tree, rules)


def mentioned(layout: Layout) -> FrozenSet[str]:
    """The mesh axes a layout splits some dimension over."""
    return frozenset(a for entry in layout for a in entry)


def shard_slices(shape: Tuple[int, ...], layout: Layout, comm,
                 name: str = "leaf") -> Tuple[slice, ...]:
    """The block of a leaf of ``shape`` that the rank of ``comm`` stores
    under ``layout``. A dimension that does not divide by its mesh axes
    raises, naming the leaf: nothing is padded."""
    out = []
    for dim, axes in zip(shape, layout):
        n, idx = 1, 0
        for a in axes:
            size = comm.axis_size(a)
            n, idx = n * size, idx * size + comm.axis_index(a)
        if dim % n:
            raise ValueError(
                f"{name}: dim of {dim} does not split over mesh axes "
                f"{axes} ({n} shards) under layout {layout}")
        step = dim // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def owns(layout: Layout, comm) -> bool:
    """Whether the rank of ``comm`` is the owner of its shard: the rank at
    index 0 of every mesh axis the layout does not mention, so each unique
    shard has exactly one owner."""
    skip = mentioned(layout)
    return all(comm.axis_index(a) == 0 for a in MESH_AXES if a not in skip)


class MeshPoint:
    """The rank at ``coords`` (axis -> index) of a mesh of axis sizes
    ``shape``: what ``shard_slices`` and ``owns`` read of a communicator,
    for any rank of the mesh, not only one's own."""

    def __init__(self, shape: Dict[str, int], coords: Dict[str, int]):
        self.shape, self.coords = shape, coords

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]
