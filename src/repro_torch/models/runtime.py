"""Runtime context threading the communicator and attention configuration
through model code (the port's counterpart of ``repro.models.runtime`` in
its ``spmd`` mode).

Per-rank code runs against a ``dist.comm`` communicator: ``SingleComm`` at
P = 1 (every collective the identity), ``ThreadMesh`` ranks for P > 1 in
one process, whose collectives are differentiable, so the same code trains
at any SP degree. Each rank reads its parameters as stored under the
sharding rule set ``rules`` (``dist.sharding``; ``models.factory.
shard_params``): ``dense`` gathers a leaf's FSDP-sharded dims on use, and
the gather's backward reduce-scatters the gradient (ZeRO-3); the
computation-sharded dims (``vocab``, and ``ffn`` under ``default``) stay
sharded through the blocks.

``attention`` runs StarTrail (``attention_impl='startrail'``, the ring
kernels B2 forward and B3 backward on 'cuda'; the ring baseline is its
C = 1 point), DeepSpeed-Ulysses (``attention_impl='ulysses'``: B1 forward
and B3 backward over the whole sequence, on the layers whose head counts
divide P, StarTrail on the others, as the JAX runtime dispatches per
layer), or, with ``attention_impl='local'``, the JAX local mode's
single-device attention: one ``dispatch.prefill`` over the rank's own
tokens (kernel B1 on 'cuda'), exact only at P = 1.

``batch_axes`` names the data-parallel axes: ``("data",)`` on a mesh
(a ``ThreadMesh``, or rank processes' ``ProcessComm``) with more than one
replica (``train.step.make_runtime``), so ``psum_batch`` sums the loss's
terms over replicas; ``()`` (the identity) with one replica.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import startrail as st
from repro_torch.core import ulysses as ulysses_lib
from repro_torch.dist import sharding
from repro_torch.dist.sharding import DATA_AXIS
from repro_torch.kernels import dispatch as kernels


@dataclasses.dataclass(frozen=True)
class Runtime:
    comm: object
    st_cfg: st.StarTrailConfig
    attention_impl: str = "startrail"   # 'startrail' | 'ulysses' | 'local'
    kernel_impl: str = "cuda"      # paged-decode kernel: 'ref' | 'cuda'
    device: torch.device = torch.device("cpu")
    batch_axes: Tuple[str, ...] = ()
    rules: str = "default"         # dist.sharding rule set

    # ---- axis info -----------------------------------------------------
    @property
    def sp_axes(self) -> Tuple[str, str, str]:
        return tuple(self.st_cfg.axes)

    def sp_size(self) -> int:
        n = 1
        for a in self.sp_axes:
            n *= self.comm.axis_size(a)
        return n

    def sp_rank(self) -> int:
        """Linear rank, grp-major and team-minor: (g*R + j)*C + t."""
        g, r, t = self.sp_axes
        c = self.comm.axis_size(t)
        rr = self.comm.axis_size(r)
        return (self.comm.axis_index(g) * rr
                + self.comm.axis_index(r)) * c + self.comm.axis_index(t)

    # ---- positions -----------------------------------------------------
    def positions(self, s_local: int) -> torch.Tensor:
        """Global token positions of this rank's sequence slice."""
        p = self.sp_size()
        return st.shard_positions(self.sp_rank(), s_local * p, p,
                                  self.st_cfg.seq_scheme, self.device)

    def positions_contig(self, s_local: int) -> torch.Tensor:
        """Contiguous positions (KV-cache layout), independent of scheme."""
        return self.sp_rank() * s_local + torch.arange(
            s_local, dtype=torch.int32, device=self.device)

    # ---- parameters ------------------------------------------------------
    def dense(self, leaf: torch.Tensor,
              axes: Tuple[Optional[str], ...]) -> torch.Tensor:
        """A stored parameter shard with logical ``axes`` for dense use:
        every FSDP logical axis of the rule set is all-gathered over its
        mesh axes, innermost first, so the result is the leaf in linear
        shard order; the backward reduce-scatters the gradient. Mesh axes
        of one member gather nothing."""
        fsdp = sharding.fsdp_logical(self.rules)
        table = sharding.RULES[self.rules]
        for dim, ax in enumerate(axes):
            if ax in fsdp:
                for mesh_ax in reversed(table[ax]):
                    if self.comm.axis_size(mesh_ax) > 1:
                        leaf = self.comm.all_gather(leaf, mesh_ax, dim)
        return leaf

    # ---- collectives (identities at P = 1) -------------------------------
    def psum_model(self, x):
        return self.comm.psum(x, self.sp_axes)

    def psum_scatter_model(self, x, axis: int):
        for a in self.sp_axes:
            x = self.comm.psum_scatter(x, a, axis)
        return x

    def all_gather_model(self, x, axis: int):
        g, r, t = self.sp_axes
        for a in (t, r, g):  # inverse order so tiling matches scatter
            x = self.comm.all_gather(x, a, axis)
        return x

    def psum_batch(self, x):
        """Sum over the data-parallel axes: the identity with none."""
        if self.batch_axes:
            return self.comm.psum(x, self.batch_axes)
        return x

    def psum_all(self, x):
        """Sum over the data-parallel and the SP axes (the MoE block's
        global token statistics): the identity at one rank."""
        return self.comm.psum(x, tuple(self.batch_axes) + self.sp_axes)

    def all_to_all_data(self, x, split_axis: int, concat_axis: int):
        """The tiled all-to-all over ``data`` (the MoE block's expert
        parallelism): the identity with one replica."""
        return self.comm.all_to_all(x, DATA_AXIS, split_axis, concat_axis)

    def ppermute_prev_shard(self, x):
        """Receive ``x`` from the previous SP rank in linear rank order
        (rank p sends to p + 1, as ``sp_rank`` and the state correction of
        ``models.ssm`` order them); rank 0 receives zeros, as does the one
        rank of P = 1. The Mamba conv's halo. Its backward is the
        transposed permutation (``dist.comm``)."""
        p = self.sp_size()
        return self.comm.ppermute(x, self.sp_axes,
                                  [(i, i + 1) for i in range(p - 1)])

    def all_gather_sp_stack(self, x):
        """Gather per-rank values into a leading SP dim (P, ...), in linear
        rank order."""
        g, r, t = self.sp_axes
        y = x[None]
        for a in (t, r, g):
            y = self.comm.all_gather(y, a, 0)
        return y

    # ---- attention -------------------------------------------------------
    def attention(self, q, k, v, *, causal=None, window=None,
                  prefix_len=None) -> torch.Tensor:
        cfg = self.st_cfg
        if causal is not None and causal != cfg.causal:
            cfg = dataclasses.replace(cfg, causal=causal)
        if window != cfg.window:
            cfg = dataclasses.replace(cfg, window=window)
        if prefix_len != cfg.prefix_len:
            cfg = dataclasses.replace(cfg, prefix_len=prefix_len)
        if self.attention_impl == "local":
            # one block over this rank's own tokens (the JAX local mode's
            # single-device attention): kernel B1 on 'cuda'
            pos = self.positions(q.shape[1])
            return kernels.prefill(
                q, k, v, pos, pos, causal=cfg.causal, window=cfg.window,
                scale=cfg.scale, prefix_len=cfg.prefix_len,
                impl=cfg.block_impl)
        if self.attention_impl == "ulysses":
            # per layer: Ulysses only where this layer's head counts divide
            # the SP degree (the plan rejects a config where none does);
            # StarTrail on the others
            sp = self.sp_size()
            if q.shape[2] % sp == 0 and k.shape[2] % sp == 0:
                return ulysses_lib.ulysses_attention(q, k, v, cfg,
                                                     self.comm)
        return st.startrail_attention(q, k, v, cfg, self.comm)
