"""ExecutionPlan: the resolved description of one run (the port's
counterpart of ``repro.plan.plan``, cut to the fields the engine, the
trainer and the train step read).

``make_plan`` (training) and ``make_serve_plan`` (serving) need an explicit
StarTrail ``c``: the JAX package picks it with the analytical cost model's
time half (``repro.plan.cost.rank_arrangements``), which is not ported yet,
so ``c=None`` raises (ROADMAP.md §A). The scheme half is ported
(``plan.cost``): ``make_plan`` checks the scheme with
``cost.check_scheme`` as the JAX one does.

A training plan with ``n_devices > 1`` runs its ranks as the threads of a
``dist.comm.ThreadMesh(c, r, data, placement)`` on one device
(``build_mesh``), the port's counterpart of the JAX package's forced host
devices (``local_mesh_for_tests``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.dist.meshes import PLACEMENTS
from repro_torch.kernels.dispatch import IMPLS, resolve_impl
from repro_torch.models.transformer import REMATS
from repro_torch.plan import cost


def _no_cost_model(entry: str) -> NotImplementedError:
    return NotImplementedError(
        f"{entry}(c=None) needs the analytical cost model "
        "(repro/plan/cost.py), not ported yet (ROADMAP.md §A): pass c")


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Fully-resolved run. P_sp = n_devices / data. Serving caches use the
    contiguous sequence layout; training uses zigzag (causal balance)."""

    arch: str
    seq_len: int                   # train: sequence; serve: engine capacity
    n_devices: int
    data: int = 1
    c: int = 1
    placement: str = "team_inner"  # ThreadMesh coordinates (dist.meshes)
    block_impl: str = "cuda"       # ring-step block kernel ('ref' | 'cuda')
    block_skip: bool = False
    decode_batch: int = 0          # engine decode slots (0 = not a serve plan)
    page_size: int = 0             # KV page tokens (0 = not a serve plan)
    kernel_impl: str = "cuda"      # paged-decode kernel ('ref' | 'cuda')
    prefix_cache: bool = False     # the engine shares prompt pages
    host_tier_bytes: int = 0       # not ported: the engine raises
    # ---- training face (kind='train' plans, from make_plan) ---------------
    shape: str = "serve"           # shape name ('train_4k', 'smoke', ...)
    global_batch: int = 0
    kind: str = "decode"           # 'train' | 'prefill' | 'decode'
    scheme: str = "startrail"      # 'startrail' | 'ring' | 'ulysses'
    seq_scheme: str = "contiguous"
    remat: str = "attn_out"        # 'none' | 'attn_out' | 'full'
    microbatches: int = 1
    comm_chunks: int = 1           # ring-transfer sub-chunks

    @property
    def sp_size(self) -> int:
        return self.n_devices // self.data

    @property
    def r(self) -> int:
        return self.sp_size // (self.c * self.c)

    def __post_init__(self):
        if self.data < 1 or self.n_devices < 1 or self.n_devices % self.data:
            raise ValueError(f"n_devices={self.n_devices} not divisible by "
                             f"data={self.data}")
        if self.placement not in PLACEMENTS:
            raise ValueError(f"placement must be one of {PLACEMENTS}, "
                             f"got {self.placement!r}")
        sp = self.sp_size
        if self.c < 1 or sp % (self.c * self.c):
            raise ValueError(
                f"C={self.c} invalid for P={sp}: need P % C^2 == 0")
        if self.seq_len % sp:
            raise ValueError(
                f"seq_len={self.seq_len} not divisible by SP={sp}")
        for knob, val in (("block_impl", self.block_impl),
                          ("kernel_impl", self.kernel_impl)):
            if val not in IMPLS:
                raise ValueError(f"{knob} must be one of {IMPLS}, "
                                 f"got {val!r}")
        if self.decode_batch < 0 or self.page_size < 0:
            raise ValueError("decode_batch/page_size must be >= 0")
        if self.page_size and self.seq_len % self.page_size:
            raise ValueError(
                f"seq_len={self.seq_len} not divisible by "
                f"page_size={self.page_size}")
        if self.scheme not in cost.SCHEMES:
            raise ValueError(f"scheme must be one of {cost.SCHEMES}, "
                             f"got {self.scheme!r}")
        if self.scheme in ("ring", "ulysses") and self.c != 1:
            raise ValueError(f"scheme {self.scheme!r} implies C=1, "
                             f"got C={self.c}")
        if self.seq_scheme == "zigzag" and self.seq_len % (2 * sp):
            raise ValueError(
                f"zigzag layout needs seq_len % (2*P) == 0, got "
                f"seq_len={self.seq_len}, P={sp}")
        if self.microbatches < 1:
            raise ValueError("microbatches must be >= 1")
        if self.comm_chunks < 1:
            raise ValueError("comm_chunks must be >= 1")
        s_team = self.c * self.seq_len // sp
        if self.comm_chunks > 1 and s_team % self.comm_chunks:
            raise ValueError(
                f"comm_chunks={self.comm_chunks} must divide the team "
                f"sequence length C*N/P = {s_team} (the axis the chunked "
                f"ring ppermute splits)")
        if self.remat not in REMATS:
            raise ValueError(f"remat must be one of {REMATS}, "
                             f"got {self.remat!r}")
        if self.kind == "train":
            if self.global_batch % self.data:
                raise ValueError(
                    f"global_batch={self.global_batch} not divisible by "
                    f"dp={self.data}")
            if (self.global_batch // self.data) % self.microbatches:
                raise ValueError(
                    f"per-device batch {self.global_batch // self.data} "
                    f"not divisible by microbatches={self.microbatches}")

    # ---- the objects the trainer consumes --------------------------------
    def shape_config(self) -> ShapeConfig:
        return ShapeConfig(self.shape, seq_len=self.seq_len,
                           global_batch=self.global_batch, kind=self.kind)

    def run_config(self) -> RunConfig:
        return RunConfig(
            c=self.c, attention_scheme=self.scheme,
            microbatches=self.microbatches, seq_scheme=self.seq_scheme,
            block_impl=self.block_impl, kernel_impl=self.kernel_impl,
            block_skip=self.block_skip, remat=self.remat,
            comm_chunks=self.comm_chunks)

    def build_mesh(self):
        """The ``ThreadMesh`` of the plan's ranks; None for one device."""
        if self.n_devices == 1:
            return None
        from repro_torch.dist.comm import ThreadMesh

        return ThreadMesh(self.c, self.r, self.data, self.placement)

    def build_train_step(self, model, adam_cfg, comm=None):
        """(step, sh) -- see ``train.step.build_train_step``; ``comm``
        defaults to ``build_mesh()``."""
        from repro_torch.train import step as train_step

        return train_step.build_train_step(
            model, self.run_config(), self.shape_config(), adam_cfg,
            comm or self.build_mesh())


def make_plan(cfg: ModelConfig, shape: ShapeConfig, *,
              arch: Optional[str] = None, n_devices: int = 1, data: int = 1,
              c: Optional[int] = None, scheme: Optional[str] = None,
              placement: Optional[str] = None,
              microbatches: Optional[int] = None,
              block_impl: Optional[str] = None,
              kernel_impl: Optional[str] = None,
              remat: str = "attn_out",
              comm_chunks: Optional[int] = None) -> ExecutionPlan:
    """Resolve one training run into a validated ExecutionPlan.

    The sequence layout is zigzag for a dense model's training attention
    (causal load balance) and contiguous otherwise; ring-block skipping is
    on for a sliding window over the contiguous layout, as in the JAX
    package. ``block_impl`` / ``kernel_impl`` default to 'cuda' (the plain
    versions on CPU tensors). ``remat`` defaults to 'attn_out', as in the
    JAX plan. ``microbatches=None`` means 1: the JAX package picks it with
    the cost model's ``choose_microbatches``, not ported yet (ROADMAP.md
    §A); the per-device batch must divide by it. ``placement`` (default
    'team_inner') only matters for C > 1, as in the JAX plan. An explicit
    ``scheme`` is checked by ``cost.check_scheme`` (Ulysses needs head
    counts that divide P). ``comm_chunks=None`` means 1: the JAX package
    picks it with the cost model's ``choose_comm_chunks``, not ported yet.
    """
    if n_devices % data:
        raise ValueError(f"n_devices={n_devices} not divisible by "
                         f"data={data}")
    if scheme is not None:
        cost.check_scheme(cfg, n_devices // data, scheme)
    if c is None:
        raise _no_cost_model("make_plan")
    if cfg.family in ("ssm", "hybrid") or shape.kind != "train":
        seq_scheme = "contiguous"
    else:
        seq_scheme = "zigzag"
    return ExecutionPlan(
        arch=arch or cfg.name, seq_len=shape.seq_len, n_devices=n_devices,
        data=data, c=c,
        placement=placement if placement and c > 1 else "team_inner",
        block_impl=resolve_impl(block_impl),
        block_skip=cfg.window is not None and seq_scheme == "contiguous",
        kernel_impl=resolve_impl(kernel_impl), shape=shape.name,
        global_batch=shape.global_batch, kind=shape.kind,
        scheme=scheme or "startrail", seq_scheme=seq_scheme, remat=remat,
        microbatches=microbatches or 1, comm_chunks=comm_chunks or 1)


def make_serve_plan(cfg: ModelConfig, *, arch: Optional[str] = None,
                    n_devices: int = 1, data: int = 1,
                    c: Optional[int] = None, decode_batch: int = 4,
                    page_size: int = 8, max_len: int = 512,
                    kernel_impl: Optional[str] = None,
                    block_impl: Optional[str] = None,
                    prefix_cache: bool = False,
                    host_tier_bytes: int = 0) -> ExecutionPlan:
    """Resolve one serving run into a plan.

    ``seq_len`` is the engine capacity (``max_len`` rounded up so both the
    SP degree and the page size divide it). A sliding window turns
    ring-block skipping on, as in the JAX package's contiguous layout.
    """
    if c is None:
        raise _no_cost_model("make_serve_plan")
    if n_devices % data:
        raise ValueError(f"n_devices={n_devices} not divisible by "
                         f"data={data}")
    if page_size < 1:
        raise ValueError("page_size must be >= 1")
    if decode_batch < 1:
        raise ValueError("decode_batch must be >= 1")
    quantum = math.lcm(n_devices // data, page_size)
    seq_len = ((max_len + quantum - 1) // quantum) * quantum
    return ExecutionPlan(
        arch=arch or cfg.name, seq_len=seq_len, n_devices=n_devices,
        data=data, c=c, block_impl=resolve_impl(block_impl),
        block_skip=cfg.window is not None, decode_batch=decode_batch,
        page_size=page_size, kernel_impl=resolve_impl(kernel_impl),
        prefix_cache=prefix_cache, host_tier_bytes=host_tier_bytes)
