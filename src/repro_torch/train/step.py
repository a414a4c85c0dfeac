"""The train step (the port's counterpart of ``repro.train.step``): the
model's loss and gradients, then AdamW.

The JAX package runs forward and backward inside one ``shard_map`` island
per device; the port runs the same per-rank code eagerly under autograd:
on one card through ``SingleComm`` (P = 1, one data replica), or as the
ranks of a ``dist.comm.ThreadMesh`` (data replicas times SP ranks, threads
of one process on the CPU or on one card), whose collectives carry
gradients.

Storage. Each rank reads its parameters as the rule set
``run_cfg.sharding_rules`` stores them (``dist.sharding``): every call
takes fresh views of the rank's shards of the ``Model``'s tensors as
leaves of their own (``factory.shard_params(trainable=True)``), so
autograd returns gradients of the shards' shapes.

Reduction. Every rank's loss is the replicated global loss and its
backward seeds 1, so ``value_and_grad`` reduces each leaf as the JAX
``reduce_leaf`` does: in f32, times 1/n_devices, summed over the mesh axes
(of more than one member) that the leaf's layout does not mention, then
cast once to the parameter dtype. The FSDP dims were reduce-scattered
already by the backward of ``Runtime.dense``'s gather; under ``default``
at one data replica the MLP weights and the vocab tables take no sum at
all. The reduction counts in the communicator's ledger as backward traffic
(``dist.comm.CommLedger``). A MoE stack's auxiliary losses are part of
that loss, summed over every rank by ``Runtime.psum_all`` as the JAX
block sums them, so the same reduction gives JAX's gradients.

Update. On a ``ThreadMesh``, ``build_train_step``'s step takes the global
batch (its sequence in SP shard order, as ``data.pipeline`` lays it out)
and runs ``value_and_grad`` on every rank thread over the rank's part of
it (``shard_batch``). Each unique shard's reduced gradient is kept by one
owner (``dist.sharding.owns``; its replicas hold the same bits: the mesh
sums each group in one order), and the other ranks drop theirs as each
leaf is reduced. AdamW then runs once over the unique shards, on views of
the parameters and of the moments (``adamw.state_partition``), so each
unique shard is updated exactly once. On one card a leaf's unique shards
tile it, so the moments are kept as whole tensors: they hold exactly the
shards' moments, and checkpoints keep the JAX format of whole leaves.

With ``microbatches = M > 1`` the step accumulates gradients as the JAX
``_make_vg_island`` does: the per-device batch is cut into M equal slices
of consecutive rows, each slice's gradients (in the parameter dtype) are
added into f32 accumulators of the shards' shapes, and loss and gradients
are the sums over M, before the reduction above. With
``grad_compression='int8'`` the step passes the reduced gradients through
``optim.grad.int8_roundtrip`` before AdamW, as the JAX step does, with
each leaf's per-tensor scale taken over all of its unique shards (JAX
quantises the global array).

``attention_scheme`` selects the runtime's attention: 'startrail' and
'ring' (its C = 1 point) run ``core.startrail`` with the plan's
``comm_chunks`` and issue order (``pipeline_scan``); 'ulysses' runs
``core.ulysses`` on the layers whose head counts divide P.

Ranks as processes. With ``comm`` a ``dist.comm.ProcessComm`` the step
runs this process's rank alone, on the ``models.factory.rank_model`` that
holds its shards: ``shard_batch`` of the global batch, ``value_and_grad``
over every shard it holds, then AdamW over those shards with shard-sized
moments of their own (``adamw.init_state`` of the shards). Every rank
holding a replica of a shard updates it, as the JAX step updates every
device's replica: the mesh's reductions give the replicas the same bits,
so they stay equal. The gradient norm and each leaf's int8 scale count
every unique shard once, from its owner: each rank writes its owned
shards' sums of squares (or max |value|) into a (rank, leaf) table, the
mesh sums (maxes) it, and the norm adds the owners' entries leaf by leaf
in rank order, the ``ThreadMesh`` step's order, so both give the same bits.
These two tables are bookkeeping a ``ThreadMesh`` reads from shared
memory, so they stay out of the ledger (``CommLedger.uncounted``).

Not ported yet, and raising with its ROADMAP.md item: ``multi_pod`` (§A
item 1 b, the ``pod`` axis). The ring's pipelined issue order runs on
either communicator (``pipeline_scan``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.core.startrail import StarTrailConfig
from repro_torch.dist import sharding
from repro_torch.dist.comm import ProcessComm, SingleComm, ThreadMesh
from repro_torch.dist.sharding import DATA_AXIS, MESH_AXES
from repro_torch.models.factory import Model, shard_blocks, shard_params
from repro_torch.models.runtime import Runtime
from repro_torch.optim import adamw
from repro_torch.optim import grad as grad_lib

COMPRESSIONS = ("none", "int8")
# (leaf index in ``named_parameters`` order, its block, reduced gradient)
Shard = Tuple[int, Tuple[slice, ...], torch.Tensor]


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md §A item 1 b, "
        "the pod axis)")


def make_runtime(model: Model, run_cfg: RunConfig, shape: ShapeConfig,
                 comm=None) -> Runtime:
    """The runtime of one training rank on ``comm`` (default: one card)."""
    cfg = model.cfg
    if run_cfg.multi_pod:
        raise _unported("multi-pod meshes")
    scheme = run_cfg.seq_scheme
    if cfg.family in ("ssm", "hybrid"):
        scheme = "contiguous"   # the recurrent state passing needs it
    st = StarTrailConfig(
        seq_len=shape.seq_len,
        seq_scheme=scheme,
        causal=True,
        window=cfg.window,
        block_impl=run_cfg.block_impl,
        block_skip=run_cfg.block_skip or (cfg.window is not None
                                          and scheme == "contiguous"),
        comm_chunks=run_cfg.comm_chunks,
        pipeline=run_cfg.pipeline_scan,
    )
    comm = comm or SingleComm()
    # 'ring' is the C = 1 StarTrail config; 'ulysses' dispatches per layer
    # in Runtime.attention (head counts permitting)
    impl = "ulysses" if run_cfg.attention_scheme == "ulysses" else "startrail"
    return Runtime(comm=comm, st_cfg=st, attention_impl=impl,
                   kernel_impl=run_cfg.kernel_impl, device=model.device,
                   batch_axes=(DATA_AXIS,) if comm.axis_size(DATA_AXIS) > 1
                   else (), rules=sharding.check_rules(
                       run_cfg.sharding_rules))


def shard_batch(batch: Dict[str, torch.Tensor], rt: Runtime
                ) -> Dict[str, torch.Tensor]:
    """The rank of ``rt``'s part of a global batch whose sequence is laid
    out in SP shard order (``data.pipeline.shard_permutation``): its rows
    by data index, its columns by SP rank."""
    data, d = rt.comm.axis_size(DATA_AXIS), rt.comm.axis_index(DATA_AXIS)
    p, q = rt.sp_size(), rt.sp_rank()
    out = {}
    for k, v in batch.items():
        rows, cols = v.shape[0] // data, v.shape[1] // p
        if rows * data != v.shape[0] or cols * p != v.shape[1]:
            raise ValueError(f"batch {k} {tuple(v.shape)} does not split "
                             f"over data={data} and SP={p}")
        out[k] = v[d * rows:(d + 1) * rows, q * cols:(q + 1) * cols]
    return out


def reduce_leaf(rt: Runtime, g: torch.Tensor, layout: sharding.Layout,
                dtype: torch.dtype) -> torch.Tensor:
    """JAX's ``reduce_leaf``: this rank's gradient ``g`` of a leaf shard
    stored under ``layout``, in f32 times 1/n_devices, summed over the
    mesh axes (of more than one member) the layout does not mention, then
    cast once to ``dtype``. Every rank of a leaf sums over the same axes,
    so the collectives meet. The result is contiguous: autograd may
    return a leaf's gradient transposed (the vocab rows' from the logits'
    product), and the norm and AdamW then reduce it in another order."""
    comm = rt.comm
    g32 = g.float().contiguous() * (
        1.0 / (rt.sp_size() * comm.axis_size(DATA_AXIS)))
    skip = sharding.mentioned(layout)
    axes = tuple(a for a in MESH_AXES
                 if a not in skip and comm.axis_size(a) > 1)
    if axes:
        g32 = comm.psum(g32, axes)
    return g32.to(dtype)


def _value_and_grad(model: Model, run_cfg: RunConfig, rt: Runtime
                    ) -> Callable:
    if run_cfg.grad_compression not in COMPRESSIONS:
        raise ValueError(f"grad_compression must be one of {COMPRESSIONS}, "
                         f"got {run_cfg.grad_compression!r}")
    comm = rt.comm
    mb = max(run_cfg.microbatches, 1)
    layouts = model.partition(rt.rules)
    owner = {n: sharding.owns(lay, comm) for n, lay in layouts.items()}

    def loss_and_grads(params, leaves, batch):
        loss = model.loss(rt, params, batch, remat=run_cfg.remat)
        return loss, list(torch.autograd.grad(loss, leaves))

    def accumulate(params, leaves, batch):
        rows = next(iter(batch.values())).shape[0]
        if rows % mb:
            raise ValueError(f"per-device batch {rows} not divisible by "
                             f"microbatches={mb}")
        n = rows // mb
        loss_sum = torch.zeros((), dtype=torch.float32, device=rt.device)
        g_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
        for i in range(mb):
            l_mb, g_mb = loss_and_grads(
                params, leaves,
                {k: v[i * n:(i + 1) * n] for k, v in batch.items()})
            with torch.no_grad():
                loss_sum += l_mb.float()
                for acc, g in zip(g_sum, g_mb):
                    acc.add_(g)
            del g_mb
        return loss_sum / mb, [g.div_(mb) for g in g_sum]

    def vg_fn(batch: Dict[str, torch.Tensor], owned_only: bool = False):
        params = shard_params(model, comm, rt.rules, trainable=True)
        names, leaves = list(params.named), list(params.named.values())
        loss, grads = (loss_and_grads(params, leaves, batch) if mb == 1
                       else accumulate(params, leaves, batch))
        out = []
        with torch.no_grad(), comm.ledger.backward():
            for i, (name, p) in enumerate(zip(names, leaves)):
                # reduce in f32, downcast once at the end; the rank's own
                # gradient goes as soon as it is reduced
                g = reduce_leaf(rt, grads[i], layouts[name], p.dtype)
                grads[i] = None
                out.append(g if owner[name] or not owned_only else None)
        return loss.detach(), out

    return vg_fn


def build_value_and_grad_fn(model: Model, run_cfg: RunConfig,
                            shape: ShapeConfig, comm=None
                            ) -> Tuple[Callable, Runtime]:
    """Returns (vg_fn, rt) with vg_fn(batch) -> (loss, grads): the loss and
    the reduced gradient of the rank's shard of every parameter, in
    ``named_parameters`` order, on the rank ``comm`` (one card by default,
    where every shard is the whole leaf; a ``ThreadMesh`` rank's ``comm``
    inside its ``run``). ``batch`` is the rank's part of the global batch
    (``shard_batch``). ``vg_fn(batch, owned_only=True)`` takes part in the
    reduction but keeps only the shards this rank owns (None elsewhere)."""
    rt = make_runtime(model, run_cfg, shape, comm)
    return _value_and_grad(model, run_cfg, rt), rt


def _shard_grads_fn(model: Model, run_cfg: RunConfig, shape: ShapeConfig,
                    comm, timeout: float = 600.0) -> Callable:
    """fn(global batch) -> (loss, shards): every unique shard's reduced
    gradient once, from its owner (module doc), as ``Shard`` triples
    ordered by leaf. ``comm`` is a ``ThreadMesh`` or one card's
    ``SingleComm``."""
    def fn(batch: Dict[str, torch.Tensor]):
        def rank_fn(rank_comm):
            rt = make_runtime(model, run_cfg, shape, rank_comm)
            loss, grads = _value_and_grad(model, run_cfg, rt)(
                shard_batch(batch, rt), owned_only=True)
            return loss, [(i, sl, g) for i, (sl, g) in enumerate(
                zip(shard_blocks(model, rank_comm, rt.rules), grads))
                if g is not None]

        out = (comm.run(rank_fn, timeout) if isinstance(comm, ThreadMesh)
               else [rank_fn(comm)])
        shards = sorted((s for _, rank in out for s in rank),
                        key=lambda s: s[0])
        return out[0][0], shards

    return fn


def assemble(params: List[torch.Tensor], shards: List[Shard]
             ) -> List[torch.Tensor]:
    """Whole tensors shaped like ``params`` from their unique shards."""
    whole = [torch.empty_like(p) for p in params]
    for i, sl, g in shards:
        whole[i][sl] = g
    return whole


def build_mesh_value_and_grad_fn(model: Model, run_cfg: RunConfig,
                                 shape: ShapeConfig, mesh: ThreadMesh,
                                 timeout: float = 600.0) -> Callable:
    """vg_fn(batch) -> (loss, grads) over every rank of ``mesh``: ``batch``
    is the global batch in SP shard order; each gradient is whole, in
    ``named_parameters`` order, assembled from its unique shards' reduced
    gradients."""
    fn = _shard_grads_fn(model, run_cfg, shape, mesh, timeout)
    params = [p for _, p in model.named_parameters()]

    def vg_fn(batch: Dict[str, torch.Tensor]):
        loss, shards = fn(batch)
        return loss, assemble(params, shards)

    return vg_fn


def build_train_step(model: Model, run_cfg: RunConfig, shape: ShapeConfig,
                     adam_cfg: adamw.AdamWConfig, comm=None):
    """Returns (step, sh) with step(opt_state, batch) -> (opt_state,
    metrics). The step updates the model's parameters in place, each
    unique shard once (module doc); ``sh`` holds the whole parameters the
    optimizer state mirrors (``sh['params']``, ``sh['names']``: give
    ``adamw.init_state`` the former) and the communicator the step runs on
    (``sh['comm']``: its ``ledgers`` count the step's wire bytes, the
    parameter gathers and gradient reductions of the rules included). With
    ``comm`` a ``ThreadMesh`` the step runs every rank on the global
    batch."""
    comm = comm or SingleComm()
    if isinstance(comm, ProcessComm):
        return _process_train_step(model, run_cfg, shape, adam_cfg, comm)
    grads_fn = _shard_grads_fn(model, run_cfg, shape, comm)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]

    def step(opt_state, batch):
        loss, shards = grads_fn(batch)
        index = [(i, sl) for i, sl, _ in shards]
        grads = [g for _, _, g in shards]
        if run_cfg.grad_compression == "int8":
            grads = grad_lib.int8_roundtrip(grads, [i for i, _ in index])
        state = adamw.state_partition(opt_state, index)
        _, state, metrics = adamw.apply(
            [params[i][sl] for i, sl in index], grads, state, adam_cfg)
        opt_state["step"] = state["step"]
        metrics["loss"] = loss
        return opt_state, metrics

    return step, dict(params=params, names=names, comm=comm)


def _process_train_step(model: Model, run_cfg: RunConfig,
                        shape: ShapeConfig, adam_cfg: adamw.AdamWConfig,
                        comm: ProcessComm):
    """``build_train_step`` on one rank process (module doc): ``model`` is
    its ``rank_model``, ``sh['params']`` its shards, ``sh['held']`` their
    whole shapes, rules and blocks, ``sh['layouts']`` their layouts."""
    rt = make_runtime(model, run_cfg, shape, comm)
    vg_fn = _value_and_grad(model, run_cfg, rt)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    layouts = model.partition(rt.rules)
    # every unique shard as (leaf, owner), by leaf and then rank: the order
    # in which the ThreadMesh step adds their norms
    points = [sharding.MeshPoint(comm.shape, comm.coords(q))
              for q in range(comm.size)]
    owners = [(i, q) for i, n in enumerate(names) for q in range(comm.size)
              if sharding.owns(layouts[n], points[q])]
    mine = [i for i, q in owners if q == comm.rank]

    def table(values, rows: int) -> torch.Tensor:
        """(rows, leaves) f32 zeros with this rank's owned ``values`` in
        its row (row 0 when ``rows`` is 1)."""
        out = torch.zeros(rows, len(names), dtype=torch.float32,
                          device=rt.device)
        if mine:
            out[comm.rank if rows > 1 else 0, mine] = torch.stack(values)
        return out

    def step(opt_state, batch):
        loss, grads = vg_fn(shard_batch(batch, rt))
        with torch.no_grad(), comm.ledger.uncounted():
            if run_cfg.grad_compression == "int8":
                amax = grad_lib.shard_amax([grads[i] for i in mine], mine)
                amax = comm.pmax(table([amax[i] for i in mine], 1),
                                 MESH_AXES)[0]
                grads = grad_lib.int8_roundtrip(
                    grads, amax={i: amax[i] for i in range(len(names))})
            sums = comm.psum(table(adamw.square_sums(
                [grads[i] for i in mine]), comm.size), MESH_AXES)
            gnorm = adamw.norm_of([sums[q, i] for i, q in owners])
        _, opt_state, metrics = adamw.apply(params, grads, opt_state,
                                            adam_cfg, gnorm=gnorm)
        metrics["loss"] = loss
        return opt_state, metrics

    return step, dict(params=params, names=names, comm=comm,
                      held=model.held, layouts=layouts)


def build_loss_fn(model: Model, run_cfg: RunConfig, shape: ShapeConfig,
                  comm=None) -> Tuple[Callable, Runtime]:
    """Loss only (eval): fn(batch) -> loss, with no autograd graph."""
    rt = make_runtime(model, run_cfg, shape, comm)
    params = shard_params(model, rt.comm, rt.rules)

    def fn(batch):
        with torch.no_grad():
            return model.loss(rt, params, batch, remat=run_cfg.remat)

    return fn, rt


def to_device(batch, device: torch.device) -> Dict[str, torch.Tensor]:
    """A host (numpy) batch on ``device``. From pinned memory the copy is
    asynchronous, so it does not wait for the card to finish the previous
    step."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out
