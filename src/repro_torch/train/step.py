"""The train step (the port's counterpart of ``repro.train.step``): the
model's loss and gradients, then AdamW.

The JAX package runs forward and backward inside one ``shard_map`` island
per device; the port runs the same per-rank code eagerly under autograd:
on one card through ``SingleComm`` (P = 1, one data replica), or as the
ranks of a ``dist.comm.ThreadMesh`` (data replicas times SP ranks, threads
of one process on the CPU or on one card), whose collectives carry
gradients. Every rank's loss is the replicated global loss and its
backward seeds 1, so gradients leave ``value_and_grad`` reduced as the JAX
``reduce_leaf`` does: in f32, times 1/n_devices, summed over the data and
SP axes (the port stores every parameter whole, so no axis is
"mentioned"; the identity on one card), then cast once to the parameter
dtype.

On a ``ThreadMesh``, ``build_train_step``'s step takes the global batch
(its sequence in SP shard order, as ``data.pipeline`` lays it out), runs
``value_and_grad`` on every rank thread over the rank's part of it
(``shard_batch``), and then AdamW once, on the reduced gradients of the
first thread (every rank's are the same bits: the mesh sums each group in
one order). The other ranks drop theirs as each leaf is reduced: on one
card the P ranks' gradients share its memory.

With ``microbatches = M > 1`` the step accumulates gradients as the JAX
``_make_vg_island`` does: the per-device batch is cut into M equal slices
of consecutive rows, each slice's gradients (in the parameter dtype) are
added into f32 accumulators, and loss and gradients are the sums over M,
before the reduction above. With ``grad_compression='int8'`` the step
passes the reduced gradients through ``optim.grad.int8_roundtrip`` before
AdamW, as the JAX step does.

``attention_scheme`` selects the runtime's attention: 'startrail' and
'ring' (its C = 1 point) run ``core.startrail`` with the plan's
``comm_chunks``; 'ulysses' runs ``core.ulysses`` on
the layers whose head counts divide P. The gradient reduction counts in
the communicator's ledger as backward traffic (``dist.comm.CommLedger``).

Not ported yet, and raising with its ROADMAP.md item: ``multi_pod`` (§A).
Ranks on several cards wait for the multi-process communicator (the main
path).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.core.startrail import StarTrailConfig
from repro_torch.dist.comm import SingleComm, ThreadMesh
from repro_torch.dist.sharding import DATA_AXIS
from repro_torch.models.factory import Model
from repro_torch.models.runtime import Runtime
from repro_torch.optim import adamw
from repro_torch.optim import grad as grad_lib

COMPRESSIONS = ("none", "int8")


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md §A)")


def make_runtime(model: Model, run_cfg: RunConfig, shape: ShapeConfig,
                 comm=None) -> Runtime:
    """The runtime of one training rank on ``comm`` (default: one card)."""
    cfg = model.cfg
    if run_cfg.multi_pod:
        raise _unported("multi-pod meshes")
    scheme = run_cfg.seq_scheme
    st = StarTrailConfig(
        seq_len=shape.seq_len,
        seq_scheme=scheme,
        causal=True,
        window=cfg.window,
        block_impl=run_cfg.block_impl,
        block_skip=run_cfg.block_skip or (cfg.window is not None
                                          and scheme == "contiguous"),
        comm_chunks=run_cfg.comm_chunks,
    )
    comm = comm or SingleComm()
    # 'ring' is the C = 1 StarTrail config; 'ulysses' dispatches per layer
    # in Runtime.attention (head counts permitting)
    impl = "ulysses" if run_cfg.attention_scheme == "ulysses" else "startrail"
    return Runtime(comm=comm, st_cfg=st, attention_impl=impl,
                   kernel_impl=run_cfg.kernel_impl, device=model.device,
                   batch_axes=(DATA_AXIS,) if comm.axis_size(DATA_AXIS) > 1
                   else ())


def trainable(model: Model) -> Tuple[List[str], List[torch.nn.Parameter]]:
    """The model's parameters in ``named_parameters`` order, made trainable:
    ``spec.build_module`` registers them frozen, which the serving engine
    keeps, and autograd returns no gradient for a frozen leaf."""
    names, params = [], []
    for name, p in model.named_parameters():
        p.requires_grad_(True)
        names.append(name)
        params.append(p)
    return names, params


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


def _value_and_grad(model: Model, run_cfg: RunConfig, rt: Runtime,
                    params: List[torch.nn.Parameter]) -> Callable:
    if run_cfg.grad_compression not in COMPRESSIONS:
        raise ValueError(f"grad_compression must be one of {COMPRESSIONS}, "
                         f"got {run_cfg.grad_compression!r}")
    inv = 1.0 / (rt.sp_size() * rt.comm.axis_size(DATA_AXIS))
    mb = max(run_cfg.microbatches, 1)

    def loss_and_grads(batch):
        loss = model.loss(rt, batch, remat=run_cfg.remat)
        return loss, list(torch.autograd.grad(loss, params))

    def accumulate(batch):
        rows = next(iter(batch.values())).shape[0]
        if rows % mb:
            raise ValueError(f"per-device batch {rows} not divisible by "
                             f"microbatches={mb}")
        n = rows // mb
        loss_sum = torch.zeros((), dtype=torch.float32, device=rt.device)
        g_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in params]
        for i in range(mb):
            l_mb, g_mb = loss_and_grads(
                {k: v[i * n:(i + 1) * n] for k, v in batch.items()})
            with torch.no_grad():
                loss_sum += l_mb.float()
                for acc, g in zip(g_sum, g_mb):
                    acc.add_(g)
            del g_mb
        return loss_sum / mb, [g.div_(mb) for g in g_sum]

    def vg_fn(batch: Dict[str, torch.Tensor], keep: bool = True):
        loss, grads = (loss_and_grads(batch) if mb == 1
                       else accumulate(batch))
        out = []
        with torch.no_grad(), rt.comm.ledger.backward():
            for i, p in enumerate(params):
                # reduce in f32, downcast once at the end; the rank's own
                # gradient goes as soon as it is reduced
                g = grads[i].float() * inv
                grads[i] = None
                g = rt.psum_batch(rt.psum_model(g)).to(p.dtype)
                if keep:
                    out.append(g)
        return loss.detach(), out if keep else None

    return vg_fn


def build_value_and_grad_fn(model: Model, run_cfg: RunConfig,
                            shape: ShapeConfig, comm=None
                            ) -> Tuple[Callable, Runtime]:
    """Returns (vg_fn, rt) with vg_fn(batch) -> (loss, grads): the loss and
    the reduced gradient of every parameter, in ``trainable(model)`` order,
    on the rank ``comm`` (one card by default; a ``ThreadMesh`` rank's
    ``comm`` inside its ``run``). ``batch`` is the rank's part of the
    global batch (``shard_batch``). ``vg_fn(batch, keep=False)`` takes
    part in the reduction but keeps none of it (grads None)."""
    rt = make_runtime(model, run_cfg, shape, comm)
    _, params = trainable(model)
    return _value_and_grad(model, run_cfg, rt, params), rt


def build_mesh_value_and_grad_fn(model: Model, run_cfg: RunConfig,
                                 shape: ShapeConfig, mesh: ThreadMesh,
                                 timeout: float = 600.0) -> Callable:
    """vg_fn(batch) -> (loss, grads) over every rank of ``mesh``: ``batch``
    is the global batch in SP shard order; the gradients are the first
    thread's reduced ones (each rank's are the same bits)."""
    _, params = trainable(model)

    def vg_fn(batch: Dict[str, torch.Tensor]):
        def rank_fn(comm):
            rt = make_runtime(model, run_cfg, shape, comm)
            fn = _value_and_grad(model, run_cfg, rt, params)
            return fn(shard_batch(batch, rt), keep=comm.rank == 0)

        return mesh.run(rank_fn, timeout)[0]

    return vg_fn


def build_train_step(model: Model, run_cfg: RunConfig, shape: ShapeConfig,
                     adam_cfg: adamw.AdamWConfig, comm=None):
    """Returns (step, sh) with step(opt_state, batch) -> (opt_state,
    metrics). The step updates the model's parameters in place (a PyTorch
    module owns its parameters); ``sh`` holds the parameter list the
    optimizer state mirrors (``sh['params']``, ``sh['names']``) and the
    communicator the step runs on (``sh['comm']``: its ``ledgers`` count
    the step's wire bytes). With ``comm`` a ``ThreadMesh`` the step runs
    every rank on the global batch (module doc)."""
    comm = comm or SingleComm()
    if isinstance(comm, ThreadMesh):
        vg_fn = build_mesh_value_and_grad_fn(model, run_cfg, shape, comm)
    else:
        vg_fn, _ = build_value_and_grad_fn(model, run_cfg, shape, comm)
    names, params = trainable(model)

    def step(opt_state, batch):
        loss, grads = vg_fn(batch)
        if run_cfg.grad_compression == "int8":
            grads = grad_lib.int8_roundtrip(grads)
        _, opt_state, metrics = adamw.apply(params, grads, opt_state,
                                            adam_cfg)
        metrics["loss"] = loss
        return opt_state, metrics

    return step, dict(params=params, names=names, comm=comm)


def build_loss_fn(model: Model, run_cfg: RunConfig, shape: ShapeConfig,
                  comm=None) -> Tuple[Callable, Runtime]:
    """Loss only (eval): fn(batch) -> loss, with no autograd graph."""
    rt = make_runtime(model, run_cfg, shape, comm)

    def fn(batch):
        with torch.no_grad():
            return model.loss(rt, batch, remat=run_cfg.remat)

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
