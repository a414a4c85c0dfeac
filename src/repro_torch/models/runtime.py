"""Runtime context threading the communicator and attention configuration
through model code (the port's counterpart of ``repro.models.runtime`` in
its ``spmd`` mode).

Per-rank code runs against a ``dist.comm`` communicator: ``SingleComm`` at
P = 1 (every collective the identity), ``ThreadMesh`` ranks for P > 1 in
one process. Parameters are stored whole: there is no FSDP sharding, so
``dense`` is the identity, and tensor-parallel blocks slice the rank's part
themselves (``blocks.vocab_slice``, ``blocks.mlp_block``).

``attention`` runs StarTrail (``attention_impl='startrail'``, the ring
kernels B2 forward and B3 backward on 'cuda'), or, with
``attention_impl='local'``, the JAX local mode's single-device attention:
one ``dispatch.prefill`` over the rank's own tokens (kernel B1 on 'cuda'),
exact only at P = 1.

There is one data-parallel replica (``batch_axes = ()``): ``psum_batch``
is the identity until the multi-process communicator carries a data axis
(ROADMAP.md, the main path).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import startrail as st
from repro_torch.kernels import dispatch as kernels


@dataclasses.dataclass(frozen=True)
class Runtime:
    comm: object
    st_cfg: st.StarTrailConfig
    attention_impl: str = "startrail"   # 'startrail' | 'local'
    kernel_impl: str = "cuda"      # paged-decode kernel: 'ref' | 'cuda'
    device: torch.device = torch.device("cpu")
    batch_axes: Tuple[str, ...] = ()

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
    def dense(self, leaf: torch.Tensor) -> torch.Tensor:
        """A parameter leaf for dense use: stored whole, so the identity."""
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
        return st.startrail_attention(q, k, v, cfg, self.comm)
