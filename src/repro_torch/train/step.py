"""The train step (the port's counterpart of ``repro.train.step``): the
model's loss and gradients, then AdamW.

The JAX package runs forward and backward inside one ``shard_map`` island
per device; the port runs the same per-rank code eagerly under autograd,
on one card through ``SingleComm`` (P = 1, one data replica). Gradients
leave ``value_and_grad`` reduced as the JAX ``reduce_leaf`` does: in f32,
times 1/n_devices, summed over the data and SP axes (the port stores every
parameter whole, so no axis is "mentioned"; the identity on one card),
then cast once to the parameter dtype.

Not ported yet, and raising with their ROADMAP.md item: more than one
device (the multi-process communicator with differentiable collectives is
the main path's next item), ``microbatches > 1`` and
``grad_compression != 'none'`` (§A), ``attention_scheme='ulysses'`` and
``multi_pod`` (§A).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.core.startrail import StarTrailConfig
from repro_torch.dist.comm import SingleComm
from repro_torch.models.factory import Model
from repro_torch.models.runtime import Runtime
from repro_torch.optim import adamw


def _unported(what: str, where: str = "§A") -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md {where})")


def make_runtime(model: Model, run_cfg: RunConfig, shape: ShapeConfig,
                 comm=None) -> Runtime:
    """The runtime of one training rank on ``comm`` (default: one card)."""
    cfg = model.cfg
    if run_cfg.attention_scheme == "ulysses":
        raise _unported("the Ulysses attention scheme")
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
    )
    return Runtime(comm=comm or SingleComm(), st_cfg=st,
                   kernel_impl=run_cfg.kernel_impl, device=model.device)


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


def build_value_and_grad_fn(model: Model, run_cfg: RunConfig,
                            shape: ShapeConfig, comm=None
                            ) -> Tuple[Callable, Runtime]:
    """Returns (vg_fn, rt) with vg_fn(batch) -> (loss, grads): the loss of
    ``batch`` and the reduced gradient of every parameter, in
    ``trainable(model)`` order."""
    rt = make_runtime(model, run_cfg, shape, comm)
    if rt.sp_size() != 1:
        raise _unported(
            "training at SP degree > 1 (it needs differentiable "
            "collectives: the multi-process communicator)",
            "'The main path', item 3")
    if run_cfg.microbatches > 1:
        raise _unported("gradient accumulation (microbatches > 1)")
    if run_cfg.grad_compression != "none":
        raise _unported(f"grad_compression={run_cfg.grad_compression!r}")
    _, params = trainable(model)
    inv = 1.0 / rt.sp_size()

    def vg_fn(batch: Dict[str, torch.Tensor]):
        loss = model.loss(rt, batch, remat=run_cfg.remat)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            # reduce in f32, downcast once at the end
            grads = [rt.psum_batch(rt.psum_model(g.float() * inv)).to(p.dtype)
                     for g, p in zip(grads, params)]
        return loss.detach(), grads

    return vg_fn, rt


def build_train_step(model: Model, run_cfg: RunConfig, shape: ShapeConfig,
                     adam_cfg: adamw.AdamWConfig, comm=None):
    """Returns (step, sh) with step(opt_state, batch) -> (opt_state,
    metrics). The step updates the model's parameters in place (a PyTorch
    module owns its parameters); ``sh`` holds the runtime and the
    parameter list the optimizer state mirrors (``sh['params']``,
    ``sh['names']``)."""
    vg_fn, rt = build_value_and_grad_fn(model, run_cfg, shape, comm)
    names, params = trainable(model)

    def step(opt_state, batch):
        loss, grads = vg_fn(batch)
        _, opt_state, metrics = adamw.apply(params, grads, opt_state,
                                            adam_cfg)
        metrics["loss"] = loss
        return opt_state, metrics

    return step, dict(rt=rt, params=params, names=names)


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
