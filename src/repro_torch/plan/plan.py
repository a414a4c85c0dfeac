"""ExecutionPlan: the resolved description of one run (the port's
counterpart of ``repro.plan.plan``, cut to the fields the engine, the
trainer and the train step read).

Construction paths, as in the JAX package:
  * ``make_plan(cfg, shape, ...)`` (training) and ``make_serve_plan``
    (serving): explicit knobs are validated; knobs left as None are chosen
    by the analytical cost model (``plan.cost.rank_arrangements``: scheme,
    C and placement; ``plan.cost.choose_comm_chunks``: the ring's
    sub-chunks) on the card's constants (``roofline.hw``).
  * ``plan.autotune.autotune(...)``: measured refinement of the
    analytical top-k; persists the winner to
    ``results/repro_torch/PLAN_<arch>_<shape>.json``.
  * ``ExecutionPlan.load(path)``: reuse a persisted plan (``--plan``),
    the port's or one the JAX package wrote.

A training plan with ``n_devices > 1`` runs its ranks as the threads of a
``dist.comm.ThreadMesh(c, r, data, placement)`` on one device
(``build_mesh``), the port's counterpart of the JAX package's forced host
devices (``local_mesh_for_tests``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
from typing import Dict, List, Optional, Sequence

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.core.scheduler import ClusterModel
from repro_torch.dist.meshes import PLACEMENTS
from repro_torch.dist.sharding import check_rules
from repro_torch.kernels.dispatch import IMPLS, resolve_impl
from repro_torch.models.transformer import REMATS
from repro_torch.plan import cost


# plan values the port can trace (``launch.dryrun``) but not run yet:
# (field, runnable value, ROADMAP.md item that ports them); the runnable
# paths (``build_mesh``, ``build_train_step``, the engine, the launchers)
# raise on any other value
_TRACE_ONLY_FIELDS = (
    ("pod", 1, "§A item 1, multi-pod meshes"),
    ("mesh_kind", "local", "§A item 1, meshes of several cards"),
)

ROLES = ("unified", "prefill", "decode")
MESH_KINDS = ("local", "production")


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
    replicas: int = 1              # gateway engine replicas (n_devices is
    #                                the per-replica rank count)
    prefix_cache: bool = False     # the engine shares prompt pages
    role: str = "unified"          # 'unified' | 'prefill' | 'decode':
    #                                disaggregated serving (gateway)
    host_tier_bytes: int = 0       # pinned-host KV tier capacity per
    #                                engine (0 = off; needs prefix_cache)
    # ---- training face (kind='train' plans, from make_plan) ---------------
    shape: str = "serve"           # shape name ('train_4k', 'smoke', ...)
    global_batch: int = 0
    kind: str = "decode"           # 'train' | 'prefill' | 'decode'
    scheme: str = "startrail"      # 'startrail' | 'ring' | 'ulysses'
    seq_scheme: str = "contiguous"
    remat: str = "attn_out"        # 'none' | 'attn_out' | 'full'
    microbatches: int = 1
    comm_chunks: int = 1           # ring-transfer sub-chunks
    grad_compression: str = "none"  # 'none' | 'int8' (optim/grad.py)
    sharding_rules: str = "default"  # 'default' | 'fsdp' | 'tp'
    #                                  (dist/sharding.py)
    # ---- the JAX plan's mesh face (traced by launch.dryrun; a runnable
    # plan has pod 1 and a local mesh: ``check_runnable``) --------------
    pod: int = 1
    mesh_kind: str = "local"       # 'local' (ThreadMesh) | 'production'
    # carried for the JAX record and changes nothing here: the port's
    # rings, layers and chunk loops are Python loops, which a trace (and
    # the profiler) sees every iteration of
    unroll_scans: bool = False
    # the ring's issue order (core/startrail.py): each transfer before the
    # block kernel that does not need it; both orders give the same bits
    pipeline_scan: bool = True

    @property
    def dp_size(self) -> int:
        return self.pod * self.data

    @property
    def sp_size(self) -> int:
        return self.n_devices // self.dp_size

    @property
    def r(self) -> int:
        return self.sp_size // (self.c * self.c)

    def __post_init__(self):
        if self.mesh_kind not in MESH_KINDS:
            raise ValueError(f"mesh_kind must be one of {MESH_KINDS}")
        if (self.pod < 1 or self.data < 1 or self.n_devices < 1
                or self.n_devices % self.dp_size):
            raise ValueError(f"n_devices={self.n_devices} not divisible by "
                             f"pod*data={self.dp_size}")
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
        if self.replicas < 1:
            raise ValueError("replicas must be >= 1")
        if (self.replicas > 1 or self.prefix_cache) and not self.page_size:
            raise ValueError(
                "replicas/prefix_cache are serving-face knobs: only valid "
                "on kind='decode' plans with decode_batch/page_size set "
                "(build them with plan.make_serve_plan)")
        if self.role not in ROLES:
            raise ValueError(f"role must be one of {ROLES}, "
                             f"got {self.role!r}")
        if self.role != "unified" and not self.page_size:
            raise ValueError(
                "role is a serving-face knob: only valid on plans with "
                "decode_batch/page_size set (plan.make_serve_plan)")
        if self.host_tier_bytes < 0:
            raise ValueError("host_tier_bytes must be >= 0")
        if self.host_tier_bytes and not self.prefix_cache:
            raise ValueError(
                "host_tier_bytes > 0 needs prefix_cache=True: the host "
                "tier is fed by prefix-cache eviction (spilled chains are "
                "rediscovered through the trie hash walk)")
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
        if self.grad_compression not in ("none", "int8"):
            raise ValueError(f"grad_compression must be 'none' | 'int8', "
                             f"got {self.grad_compression!r}")
        if self.remat not in REMATS:
            raise ValueError(f"remat must be one of {REMATS}, "
                             f"got {self.remat!r}")
        check_rules(self.sharding_rules)
        if self.kind == "train":
            if self.global_batch % self.dp_size:
                raise ValueError(
                    f"global_batch={self.global_batch} not divisible by "
                    f"dp={self.dp_size}")
            if (self.global_batch // self.dp_size) % self.microbatches:
                raise ValueError(
                    f"per-device batch {self.global_batch // self.dp_size} "
                    f"not divisible by microbatches={self.microbatches}")

    def check_runnable(self) -> None:
        """Raise ``NotImplementedError`` (naming its ROADMAP.md item) if
        the plan's mesh needs several cards: such a plan is traced by
        ``launch.dryrun``, never run."""
        for name, value, item in _TRACE_ONLY_FIELDS:
            if getattr(self, name) != value:
                raise NotImplementedError(
                    f"plan {name}={getattr(self, name)!r} is not ported to "
                    f"repro_torch yet (ROADMAP.md {item})")

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
            grad_compression=self.grad_compression,
            comm_chunks=self.comm_chunks, pipeline_scan=self.pipeline_scan,
            sharding_rules=self.sharding_rules, multi_pod=self.pod > 1)

    def build_mesh(self):
        """The ``ThreadMesh`` of the plan's ranks; None for one device."""
        self.check_runnable()
        if self.n_devices == 1:
            return None
        from repro_torch.dist.comm import ThreadMesh

        return ThreadMesh(self.c, self.r, self.data, self.placement)

    def build_train_step(self, model, adam_cfg, comm=None):
        """(step, sh) -- see ``train.step.build_train_step``; ``comm``
        defaults to ``build_mesh()``."""
        from repro_torch.train import step as train_step

        self.check_runnable()
        return train_step.build_train_step(
            model, self.run_config(), self.shape_config(), adam_cfg,
            comm or self.build_mesh())

    # ---- persistence (the JAX file layout, ``{"plan": {...}}``) ---------
    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["r"] = self.r           # derived, recorded for readability
        d["sp_size"] = self.sp_size
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "ExecutionPlan":
        """A plan from ``to_dict`` output, the port's or the JAX
        package's: 'pallas' reads as 'cuda'. A plan of several cards loads
        (the dry run traces it) and its runnable paths raise
        (``check_runnable``)."""
        d = {k: ("cuda" if k in ("block_impl", "kernel_impl")
                 and v == "pallas" else v) for k, v in d.items()}
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    def save(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"plan": self.to_dict()}, indent=2))
        return path

    @classmethod
    def load(cls, path) -> "ExecutionPlan":
        d = json.loads(pathlib.Path(path).read_text())
        return cls.from_dict(d["plan"] if "plan" in d else d)


def plan_path(results_dir, arch: str, shape: str) -> pathlib.Path:
    return pathlib.Path(results_dir) / f"PLAN_{arch}_{shape}.json"


def make_plan(cfg: ModelConfig, shape: ShapeConfig, *,
              arch: Optional[str] = None, n_devices: int = 1, data: int = 1,
              c: Optional[int] = None, scheme: Optional[str] = None,
              placement: Optional[str] = None,
              microbatches: Optional[int] = None,
              block_impl: Optional[str] = None,
              kernel_impl: Optional[str] = None,
              remat: str = "attn_out", grad_compression: str = "none",
              comm_chunks: Optional[int] = None,
              sharding_rules: str = "default", pod: int = 1,
              mesh_kind: str = "local", pipeline_scan: bool = True,
              overlap_frac: float = 1.0,
              cluster: Optional[ClusterModel] = None
              ) -> ExecutionPlan:
    """Resolve one training run into a validated ExecutionPlan.

    The arrangement is the first entry of ``cost.rank_arrangements``
    (fastest first, on ``cluster``: default the card's constants) that
    ``scheme``, ``c`` and ``placement`` admit, as in the JAX package:
    knobs left as None are the model's pick, an explicit illegal one
    raises (``scheme='ulysses'`` where the head counts do not divide P, a
    C with P % C^2 != 0). ``placement`` only filters C > 1. Unset
    ``comm_chunks`` resolves through ``cost.choose_comm_chunks`` at
    ``overlap_frac``, the share of each ring transfer the block kernels
    hide (the model's 1.0 by default; pass a measured one from
    ``obs.commlog.overlap_report``). ``pipeline_scan`` is the ring's issue
    order (``core.startrail``), on by default as in the JAX package.
    ``microbatches=None`` means 1, as on the JAX local
    mesh (a ``ThreadMesh`` is its counterpart), and on a production
    training plan ``cost.choose_microbatches``'s pick against the card's
    memory, as in the JAX package; the per-device batch must divide by
    it.

    The sequence layout is zigzag for a dense model's training attention
    (causal load balance) and contiguous otherwise; ring-block skipping is
    on for a sliding window over the contiguous layout. ``block_impl`` /
    ``kernel_impl`` default to 'cuda' (the plain versions on CPU
    tensors). ``remat`` defaults to 'attn_out', as in the JAX plan;
    ``sharding_rules`` to 'default'. ``pod`` and ``mesh_kind`` fill the
    JAX plan's mesh face: a plan with ``pod > 1`` or
    ``mesh_kind='production'`` is traced by ``launch.dryrun`` and refused
    by the runnable paths (ROADMAP.md §A item 1). ``unroll_scans`` keeps
    the JAX default.
    """
    dp = pod * data
    if n_devices % dp:
        raise ValueError(f"n_devices={n_devices} not divisible by "
                         f"pod*data={dp}")
    sp = n_devices // dp
    if cfg.family in ("ssm", "hybrid") or shape.kind != "train":
        seq_scheme = "contiguous"
    else:
        seq_scheme = "zigzag"
    if scheme is not None:
        cost.check_scheme(cfg, sp, scheme)
    batch = max(shape.global_batch // dp, 1)
    ranking = cost.rank_arrangements(cfg, shape, sp, batch=batch,
                                     cluster=cluster)

    def matches(arr: cost.Arrangement) -> bool:
        if scheme is not None and arr.scheme != scheme:
            return False
        if c is not None and arr.c != c:
            return False
        if placement is not None and arr.c > 1 and arr.placement != placement:
            return False
        return True

    picked = next((e["arrangement"] for e in ranking
                   if matches(e["arrangement"])), None)
    if picked is None:
        legal = sorted({e["arrangement"].key for e in ranking})
        msg = (f"no legal arrangement matches scheme={scheme!r} c={c} "
               f"placement={placement!r} at P={sp}; legal: {legal}")
        if c is not None and (c < 1 or sp % (c * c)):
            msg = f"C={c} invalid for P={sp}: need P % C^2 == 0; {msg}"
        raise ValueError(msg)
    if microbatches is None:
        microbatches = 1
        if mesh_kind == "production" and shape.kind == "train":
            microbatches = cost.choose_microbatches(
                cfg, shape, dp=dp, sp=sp, c=picked.c, remat=remat)
    if comm_chunks is None:
        comm_chunks = cost.choose_comm_chunks(
            cfg, shape, sp, picked, batch=batch, cluster=cluster,
            overlap_frac=overlap_frac)
    return ExecutionPlan(
        arch=arch or cfg.name, seq_len=shape.seq_len, n_devices=n_devices,
        data=data, c=picked.c,
        placement=picked.placement if picked.c > 1 else "team_inner",
        block_impl=resolve_impl(block_impl),
        block_skip=cfg.window is not None and seq_scheme == "contiguous",
        kernel_impl=resolve_impl(kernel_impl), shape=shape.name,
        global_batch=shape.global_batch, kind=shape.kind,
        scheme=picked.scheme, seq_scheme=seq_scheme, remat=remat,
        microbatches=microbatches, comm_chunks=comm_chunks,
        grad_compression=grad_compression, sharding_rules=sharding_rules,
        pod=pod, mesh_kind=mesh_kind, pipeline_scan=pipeline_scan)


def make_serve_plan(cfg: ModelConfig, *, arch: Optional[str] = None,
                    n_devices: int = 1, data: int = 1,
                    c: Optional[int] = None, decode_batch: int = 4,
                    page_size: int = 8, max_len: int = 512,
                    kernel_impl: Optional[str] = None,
                    block_impl: Optional[str] = None,
                    replicas: int = 1, prefix_cache: bool = False,
                    role: str = "unified", host_tier_bytes: int = 0,
                    sharding_rules: str = "default",
                    cluster: Optional[ClusterModel] = None
                    ) -> ExecutionPlan:
    """Resolve one serving run into a plan (``kind='decode'``).

    ``seq_len`` is the engine capacity (``max_len`` rounded up so both the
    SP degree and the page size divide it) and ``global_batch`` the decode
    slot count. The arrangement comes from the same ranking as a training
    plan's (``make_plan``); at P = 1 that is C = 1. A sliding window turns
    ring-block skipping on, as in the JAX package's contiguous layout.
    ``replicas`` and ``role`` fill the gateway face (``gateway.Gateway``):
    ``n_devices`` is then the rank count of each replica.
    """
    if n_devices % data:
        raise ValueError(f"n_devices={n_devices} not divisible by "
                         f"data={data}")
    if page_size < 1:
        raise ValueError("page_size must be >= 1")
    if decode_batch < 1:
        raise ValueError("decode_batch must be >= 1")
    quantum = math.lcm(n_devices // data, page_size)
    seq_len = ((max_len + quantum - 1) // quantum) * quantum
    shape = ShapeConfig("serve", seq_len=seq_len, global_batch=decode_batch,
                        kind="decode")
    base = make_plan(cfg, shape, arch=arch, n_devices=n_devices, data=data,
                     c=c, block_impl=block_impl, kernel_impl=kernel_impl,
                     sharding_rules=sharding_rules, cluster=cluster)
    return dataclasses.replace(base, decode_batch=decode_batch,
                               page_size=page_size, replicas=replicas,
                               prefix_cache=prefix_cache, role=role,
                               host_tier_bytes=host_tier_bytes)


def make_role_plans(cfg: ModelConfig, *, roles: Sequence[str],
                    n_devices: int, **kw) -> List[ExecutionPlan]:
    """One plan per replica of a disaggregated gateway, ``roles`` one entry
    per replica (e.g. ``['prefill', 'decode']``), ``n_devices`` each
    replica's rank count. Every other knob is shared, so the engines agree
    on kernels, page size and capacity, which keeps the prefill -> decode
    handoff exact. Each plan has ``replicas=1``."""
    if not roles:
        raise ValueError("roles must name at least one replica")
    kw.pop("replicas", None)
    kw.pop("role", None)
    return [make_serve_plan(cfg, n_devices=n_devices, replicas=1, role=role,
                            **kw)
            for role in roles]
