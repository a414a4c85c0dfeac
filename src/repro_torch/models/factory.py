"""Model factory: config -> parameters (the port's counterpart of
``repro.models.factory``).

``build_model(cfg, device, seed)`` makes a ``Model`` whose parameters are
drawn from a seeded ``torch.Generator`` on ``device`` with the JAX
package's per-leaf scales. ``from_jax_params(tree, cfg, device)`` carries a
JAX parameter tree (numpy arrays, as ``np.asarray`` of
``repro.models.factory.Model.init``) across: the leading period dimension
of ``tree["stack"]`` is un-stacked into per-layer modules (an
encoder-decoder tree's ``encoder`` and ``decoder`` stacks, whose leading
dimension is the layer, into ``encoder[i]`` and ``decoder[i]``) and every
leaf keeps its einsum layout, so both packages compute the same products.
``to_jax_layout(named, cfg)`` is its inverse: per-layer tensors keyed by
their ``named_parameters`` names (parameters, or their gradients) are
restacked into the JAX tree, so tests compare the two leaf by leaf.
``jax_tree`` / ``load_jax_tree`` do the same in the tensors' own dtype,
for checkpoints in the JAX package's format.

The ``Model`` holds every parameter whole, once. ``shard_params(model,
comm, rules)`` gives one rank its parameter tree under a rule set of
``dist.sharding``: each leaf the rank's stored shard, a view of the whole
tensor (no copy), and with ``trainable=True`` a leaf of its own that
requires a gradient, so autograd returns a shard-sized gradient. Blocks
read only such a tree (or the ``Model`` itself, whose leaves are the
shards of one rank). A rank process holds its shards alone:
``rank_model`` copies them out of a whole ``Model`` (built on the host
from the seed) into a ``Model`` of its own; ``build_rank_model`` draws
the whole on the rank's device first and frees it. ``run_on_ranks`` runs
a function on every rank of a ``ThreadMesh`` (or on one card, or on a rank
process's own rank) with each rank's tree, built at its first call.
Checkpoints keep whole leaves.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import sharding
from repro_torch.dist.comm import ProcessComm
from repro_torch.models import encdec, spec, transformer


class Model(nn.Module):
    """Decoder LM parameters: ``embed.table``, ``layers[i].mixer`` (wq, wk,
    wv, wo, norm; an mLSTM's wq, wk, wv, wi, wf, wo, norm; an sLSTM's wx,
    r, wo, norm; a Mamba mixer's in_proj, conv_w, A_log, dt_bias, D_skip,
    norm_in, norm, out_proj), ``layers[i].mlp`` (w1, w3, w2, norm; on a MoE layer
    router, w1, w3, w2, norm and the shared expert's ``shared``; none in an
    xLSTM stack), ``final_norm``, ``lm_head.table``. An encoder-decoder
    model (``cfg.encdec``, ``models.encdec.encdec_specs``) holds instead
    ``frontend_proj``, ``encoder[i].attn`` / ``.mlp``, ``enc_norm``,
    ``embed.table``, ``decoder[i].attn`` / ``.cross`` / ``.mlp``,
    ``final_norm`` and an untied ``lm_head.table``. The serving forward
    passes live in ``serve.step``; the training loss is ``loss``."""

    def __init__(self, cfg: ModelConfig, make):
        super().__init__()
        self.cfg = cfg
        specs = (encdec.encdec_specs(cfg) if cfg.encdec
                 else transformer.lm_specs(cfg))
        self._axes_tree = spec.axes_tree(specs)
        root = spec.build_module(specs, make)
        for name, param in root.named_parameters(recurse=False):
            self.register_parameter(name, param)   # frontend_proj
        for name, child in root.named_children():
            self.add_module(name, child)

    @property
    def head(self) -> nn.Module:
        return self.lm_head if hasattr(self, "lm_head") else self.embed

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def param_count(self) -> int:
        return spec.count_params(self)

    def axes(self) -> Dict[str, Tuple]:
        """Each parameter's logical axes, by its ``named_parameters`` name."""
        return dict(spec.named_leaves(self._axes_tree))

    def partition(self, rules: str = "default") -> Dict[str, Tuple]:
        """Each parameter's layout under the rule set ``rules``
        (``dist.sharding.partition_tree``), by name."""
        return dict(spec.named_leaves(
            sharding.partition_tree(self._axes_tree, rules)))

    def loss(self, rt, params, batch, *, remat: str = "attn_out"):
        """The training loss of ``batch`` ({tokens, labels}, and an
        encoder-decoder's ``frontend_emb``; this rank's slice) under the
        runtime ``rt``, with ``params`` the rank's tree (``shard_params``)."""
        if self.cfg.encdec:
            return encdec.encdec_loss(rt, params, batch, self.cfg,
                                      remat=remat)
        return transformer.lm_loss(rt, params, batch, self.cfg, remat=remat)


class RankParams(types.SimpleNamespace):
    """One rank's parameter tree (``shard_params``): the ``Model``'s
    nesting (``embed.table``, ``layers[i].mixer.wq``, ...) with each leaf
    the rank's stored shard; ``named`` maps the parameter names to them."""

    @property
    def head(self):
        return self.lm_head if hasattr(self, "lm_head") else self.embed


def _nest(module: nn.Module, prefix: str, named: Dict):
    if isinstance(module, nn.ModuleList):
        return [_nest(m, f"{prefix}{i}.", named)
                for i, m in enumerate(module)]
    out = {n: named[prefix + n]
           for n, _ in module.named_parameters(recurse=False)}
    for n, child in module.named_children():
        out[n] = _nest(child, f"{prefix}{n}.", named)
    return out if prefix == "" else types.SimpleNamespace(**out)


def shard_blocks(model: Model, comm, rules: str = "default"
                 ) -> List[Tuple[slice, ...]]:
    """The block of every parameter, in ``named_parameters`` order, that
    the rank of ``comm`` stores under ``rules``
    (``dist.sharding.shard_slices``), as a block of the whole leaf (also
    for a ``rank_model``). Raises, naming the leaf, where a sharded dim
    does not divide by its mesh axes."""
    layouts = model.partition(rules)
    shapes = whole_shapes(model)
    return [sharding.shard_slices(shapes[n], layouts[n], comm, n)
            for n, _ in model.named_parameters()]


def whole_shapes(model: Model) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's whole shape, by name (a ``rank_model`` holds
    only its shards of them)."""
    held = getattr(model, "held", None)
    if held is not None:
        return dict(held["shapes"])
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def rank_model(model: Model, comm, rules: str = "default",
               device=None) -> Model:
    """A ``Model`` that holds only the rank of ``comm``'s shards of
    ``model``'s parameters under ``rules`` (``shard_blocks``), each a
    contiguous allocation of its own on ``device`` (default: ``model``'s):
    a rank process's storage (``dist.comm.ProcessComm``). ``shard_params``
    of it on that rank returns its parameters themselves; ``held`` records
    the whole shapes, the rules and the blocks."""
    device = model.device if device is None else torch.device(device)
    blocks = shard_blocks(model, comm, rules)
    local = Model(model.cfg, lambda s: torch.empty(s.shape, device="meta"))
    with torch.no_grad():
        for (name, p), block in zip(model.named_parameters(), blocks):
            owner, _, leaf = name.rpartition(".")
            shard = p.detach()[block].to(device, copy=True).contiguous()
            setattr(local.get_submodule(owner), leaf,
                    nn.Parameter(shard, requires_grad=False))
    local.held = {"shapes": whole_shapes(model), "rules": rules,
                  "blocks": blocks}
    return local


def _local_blocks(model: Model, comm, rules: str
                  ) -> List[Tuple[slice, ...]]:
    """The rank of ``comm``'s block of each of ``model``'s tensors: its
    ``shard_blocks``, or the whole tensor of a ``rank_model`` (which must
    hold this rank's shards under ``rules``)."""
    blocks = shard_blocks(model, comm, rules)
    held = getattr(model, "held", None)
    if held is None:
        return blocks
    if held["rules"] != rules or held["blocks"] != blocks:
        raise ValueError(
            f"this rank_model holds the shards of another rank or rule set "
            f"({held['rules']!r}) than the rank of this comm under "
            f"{rules!r}")
    return [(slice(None),) * len(b) for b in blocks]


def shard_params(model: Model, comm, rules: str = "default", *,
                 trainable: bool = False) -> RankParams:
    """The parameter tree of the rank of ``comm`` under ``rules``: every
    leaf a view of its block of the ``Model``'s tensor (``shard_blocks``;
    the whole tensor where no mesh axis of its layout has more than one
    member, and every tensor of a ``rank_model``). With ``trainable`` each
    view is a leaf that requires a gradient; update the ``Model`` only
    under ``no_grad``, and build fresh views for the next step."""
    named = {}
    for (name, p), block in zip(model.named_parameters(),
                                _local_blocks(model, comm, rules)):
        view = p.detach()[block]
        named[name] = view.requires_grad_() if trainable else view
    return RankParams(**_nest(model, "", named), named=named)


def run_on_ranks(mesh, rt, model: Model, trees: List, fn) -> List:
    """``fn(rank_rt, rank, tree)`` on every rank under ``no_grad``, the
    results in rank order: every thread of the ``ThreadMesh`` ``mesh``,
    each with ``rt``'s communicator replaced by its own; or, when ``mesh``
    is None, one rank (index 0, ``rt`` itself): a card's ``SingleComm``,
    or this process's rank of a ``ProcessComm`` mesh, whose call returns
    its own result alone (a list of one entry: another rank's result is
    in another process, and crosses only by a collective inside ``fn``).
    A rank process's ``model`` must be its ``rank_model``, so its tree is
    the shards it holds. ``trees`` holds each rank's ``shard_params`` tree
    under ``rt.rules`` (a list of one entry a rank, None until the rank's
    first call, which builds it)."""
    if (mesh is None and isinstance(rt.comm, ProcessComm)
            and getattr(model, "held", None) is None):
        raise ValueError("a rank process holds its own shards alone: give "
                         "it factory.rank_model(model, comm, rules), not "
                         "the whole model")

    def body(comm, rank):
        rank_rt = rt if comm is None else dataclasses.replace(rt, comm=comm)
        if trees[rank] is None:
            trees[rank] = shard_params(model, rank_rt.comm, rank_rt.rules)
        with torch.no_grad():   # grad mode is per thread
            return fn(rank_rt, rank, trees[rank])

    if mesh is None:
        return [body(None, 0)]
    return mesh.run(lambda comm: body(comm, comm.rank))


def _on_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device with no card raises
    (the port runs on the card unless the caller asks for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch builds models on a CUDA card by default and none "
            "is available; pass device='cpu' to build on the CPU")
    return device


def build_model(cfg: ModelConfig, device="cuda", seed: int = 0) -> Model:
    """A model with weights drawn from ``torch.Generator(device)`` seeded
    with ``seed`` (normal, fan-in scaled; norms ones), on the card unless
    ``device`` says otherwise."""
    device = _on_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    with torch.no_grad():
        return Model(cfg, lambda s: spec.init_leaf(s, gen, cfg.param_dtype,
                                                   device))


def build_rank_model(cfg: ModelConfig, comm, rules: str = "default",
                     device="cuda", seed: int = 0) -> Model:
    """A rank process's model: the whole model drawn on ``device`` from
    ``seed`` (``build_model``: the weights a one-process run draws there),
    the rank of ``comm``'s shards kept under ``rules`` (``rank_model``),
    and the whole freed before this returns."""
    device = _on_device(device)
    whole = build_model(cfg, device=device, seed=seed)
    model = rank_model(whole, comm, rules, device)
    del whole
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return model


# an encoder-decoder tree's stacks, one row of each leaf a layer
ENCDEC_STACKS = ("encoder", "decoder")


def _layer_path(name: str, n_sub: int):
    """(JAX tree path, period) of the port parameter ``name``: a layer
    leaf ``layers.<i>.<rest>`` sits at ``stack/sub<i % n_sub>/<rest>``,
    row ``i // n_sub`` of the stacked leaf (``n_sub`` None: an
    encoder-decoder's ``encoder.<i>.<rest>`` / ``decoder.<i>.<rest>`` at
    ``encoder/<rest>`` / ``decoder/<rest>``, row ``i``); other leaves keep
    their path and have no period."""
    parts = name.split(".")
    if n_sub is None:
        if parts[0] not in ENCDEC_STACKS:
            return tuple(parts), None
        return (parts[0], *parts[2:]), int(parts[1])
    if parts[0] != "layers":
        return tuple(parts), None
    i = int(parts[1])
    return ("stack", f"sub{i % n_sub}", *parts[2:]), i // n_sub


def _stack_depths(cfg: ModelConfig) -> Dict[str, int]:
    """Each layer stack's depth, by the first part of its leaves' names."""
    if cfg.encdec:
        return {"encoder": cfg.num_encoder_layers,
                "decoder": cfg.num_layers}
    return {"layers": cfg.num_layers}


def _n_sub(cfg: ModelConfig):
    """The layers of one JAX period (None for an encoder-decoder tree,
    whose stacks have no ``sub<i>``)."""
    return None if cfg.encdec else len(transformer.layer_pattern(cfg))


def _check_jax_layout(cfg: ModelConfig) -> None:
    """Raise for a stack the JAX package cannot lay out: a hybrid stack
    cut below one period (``transformer.cut_below_period``)."""
    if transformer.cut_below_period(cfg):
        raise ValueError(
            f"{cfg.name}: {cfg.num_layers} layers cut below one period of "
            f"{transformer.period_length(cfg)} have no JAX parameter layout "
            "(its layer_pattern raises for them)")


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def jax_tree(named: Mapping[str, torch.Tensor], cfg: ModelConfig,
             device=None) -> Dict:
    """The JAX parameter tree (nested dicts of tensors) holding ``named``,
    a map from the port's parameter names (``layers.3.mixer.wq``, as
    ``Model.named_parameters`` gives them) to tensors of those shapes: the
    per-layer leaves are stacked along the JAX stack's leading period
    dimension, in their dtype, on ``device`` (default: where they are).
    Raises for a hybrid stack cut below one period."""
    _check_jax_layout(cfg)
    n_sub = _n_sub(cfg)
    groups: Dict = {}
    layers = {k: set() for k in _stack_depths(cfg)}
    for name, t in named.items():
        path, period = _layer_path(name, n_sub)
        groups.setdefault(path, {})[period] = t.detach()
        if period is not None:
            stack, i = name.split(".")[:2]
            layers[stack].add(int(i))
    for stack, depth in _stack_depths(cfg).items():
        if len(layers[stack]) != depth:
            raise ValueError(f"{len(layers[stack])} {stack} named, config "
                             f"has {depth}")
    tree: Dict = {}
    for path, rows in groups.items():
        # one leaf at a time, so only one leaf's rows are copied at once
        leaf = rows[None].to(device) if None in rows else torch.stack(
            [rows[j].to(device) for j in range(len(rows))])
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def from_jax_tree(tree, names, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The inverse of ``jax_tree``: the port parameter ``names`` mapped to
    their rows (views) of the JAX-layout tree ``tree``."""
    _check_jax_layout(cfg)
    n_sub = _n_sub(cfg)
    for stack, depth in _stack_depths(cfg).items():
        leaf = tree["stack" if n_sub is not None else stack]
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        rows = leaf.shape[0] * (n_sub or 1)
        if rows != depth:
            raise ValueError(f"tree has {leaf.shape[0]} rows of {stack} "
                             f"({n_sub or 1} layers each), config has "
                             f"{depth}")
    out = {}
    for name in names:
        path, period = _layer_path(name, n_sub)
        src = tree
        for key in path:
            src = src[key]
        out[name] = src if period is None else src[period]
    return out


def load_jax_tree(model: Model, tree) -> None:
    """Copy the JAX-layout parameter tree ``tree`` (nested dicts of
    tensors, stacked layers, as ``jax_tree`` makes it) into ``model``'s
    parameters in place, casting to each parameter's dtype."""
    named = dict(model.named_parameters())
    rows = from_jax_tree(tree, named, model.cfg)
    with torch.no_grad():
        for name, param in named.items():
            src = rows[name]
            if tuple(src.shape) != tuple(param.shape):
                raise ValueError(f"{name}: JAX leaf {tuple(src.shape)} vs "
                                 f"port {tuple(param.shape)}")
            param.copy_(src)


def from_jax_params(tree, cfg: ModelConfig, device="cuda") -> Model:
    """The port's ``Model`` holding the JAX package's parameters ``tree``,
    on the card unless ``device`` says otherwise."""
    device = _on_device(device)
    model = Model(cfg, lambda s: torch.empty(
        s.shape, dtype=spec.DTYPES[s.dtype or cfg.param_dtype],
        device=device))
    load_jax_tree(model, _map_tree(
        lambda a: torch.from_numpy(np.array(a, np.float32)), tree))
    return model


def to_jax_layout(named: Mapping[str, torch.Tensor], cfg: ModelConfig
                  ) -> Dict:
    """``jax_tree`` of ``named`` with every leaf an f32 numpy array (for
    comparing with the JAX package leaf by leaf). The inverse of
    ``from_jax_params``."""
    tree = jax_tree({n: t.detach().float().cpu() for n, t in named.items()},
                    cfg)
    return _map_tree(lambda t: t.numpy(), tree)
