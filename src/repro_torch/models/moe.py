"""Mixture-of-Experts layer with expert parallelism over ``data`` (the
port's counterpart of ``repro.models.moe``).

Layout: the experts are stored sharded over the ``data`` axis and each
expert's ffn dim over the SP axes (``dist.sharding``'s ``experts`` and
``expert_ffn`` rows); the router and the norm are replicated. Dataflow per
MoE layer, every collective through the ``Runtime``:

  route (f32 softmax, top-k, capacity) -> dispatch into (E, cap, D)
  -> all_to_all over data -> expert SwiGLU -> all_to_all back -> combine

The expert SwiGLU follows the JAX block: under ``default`` and ``tp`` the
dispatched tokens are all-gathered over the SP axes, each rank multiplies
its stored ``expert_ffn`` slice, and a reduce-scatter sums the slices;
under ``fsdp`` the expert weights are all-gathered instead.

Token-choice top-k routing with a capacity factor: the (t, k) choices
queue at their expert in token-major, choice-minor order, and those past
``_capacity`` are dropped (they pass through the residual). Capacity is
reckoned from the rank's own token count, so a rank's result depends on
its local token order and on the mesh. Load-balance and router-z
auxiliary losses are taken over the global token population
(``Runtime.psum_all``) and returned to the caller.

Dispatch and combine use indices where the JAX block contracts one-hot
(T, E, cap) tensors: a one-hot product selects exactly and its combine
adds only zeros beside the k real terms, so the values are the same.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.dist.sharding import DATA_AXIS
from repro_torch.models import blocks
from repro_torch.models.spec import PSpec

W_UP_AXES = ("experts", "expert_embed", "expert_ffn")
W_DOWN_AXES = ("experts", "expert_ffn", "expert_embed")


def moe_specs(cfg: ModelConfig):
    m = cfg.moe
    d, e, f = cfg.d_model, m.num_experts, m.d_ff_expert
    specs = {
        "router": PSpec((d, e), ("embed_nosplit", None), scale=d ** -0.5),
        "w1": PSpec((e, d, f), W_UP_AXES),
        "w3": PSpec((e, d, f), W_UP_AXES),
        "w2": PSpec((e, f, d), W_DOWN_AXES),
        "norm": blocks.rmsnorm_specs(d),
    }
    if m.shared_expert:
        specs["shared"] = blocks.mlp_specs(cfg, d_ff=m.d_ff_expert)
    return specs


def _capacity(tokens: int, m: MoEConfig) -> int:
    cap = int(tokens * m.top_k / m.num_experts * m.capacity_factor)
    return max(cap, m.top_k)


def route(probs: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gates, experts), each (T, k): the k largest probabilities of every
    row, largest first, an exact tie going to the lower expert index (as
    ``jax.lax.top_k``), and the gates renormalised to sum to 1."""
    vals, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, sel = vals[:, :top_k], sel[:, :top_k]
    return vals / vals.sum(-1, keepdim=True).clamp(min=1e-9), sel


def queue_positions(sel: torch.Tensor, num_experts: int) -> torch.Tensor:
    """(T, k) position of each choice in its expert's queue: the exclusive
    cumsum of the (T*k, E) one-hot in token-major, choice-minor order."""
    flat = sel.reshape(-1)
    onehot = F.one_hot(flat, num_experts)
    pos = (onehot.cumsum(0) - onehot).gather(1, flat[:, None])
    return pos.reshape(sel.shape)


def _expert_swiglu(rt, p, xe):
    """xe: (E_local, n, D), the tokens dispatched to this rank's experts ->
    (E_local, n, D)."""
    if rt.rules == "fsdp":
        w1 = rt.all_gather_model(p.w1, axis=2)
        w3 = rt.all_gather_model(p.w3, axis=2)
        w2 = rt.all_gather_model(p.w2, axis=1)
        u = torch.einsum("ecd,edf->ecf", xe, w1)
        g = torch.einsum("ecd,edf->ecf", xe, w3)
        a = F.silu(u.float()).to(u.dtype) * g
        return torch.einsum("ecf,efd->ecd", a, w2)
    xg = rt.all_gather_model(xe, axis=1)               # (E_l, P*n, D)
    u = torch.einsum("ecd,edf->ecf", xg, p.w1)
    g = torch.einsum("ecd,edf->ecf", xg, p.w3)
    a = F.silu(u.float()).to(u.dtype) * g
    o = torch.einsum("ecf,efd->ecd", a, p.w2)
    return rt.psum_scatter_model(o, axis=1)            # (E_l, n, D)


def moe_block(rt, p, x, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S_local, D) -> (x + y, {'moe_lb', 'moe_z'}): the residual-added
    output and the auxiliary losses."""
    m = cfg.moe
    B, S, D = x.shape
    T, E, k = B * S, m.num_experts, m.top_k
    h = blocks.rmsnorm(p.norm, x, cfg.norm_eps)
    ht = h.reshape(T, D)

    # ---- routing (float32) ----
    logits = ht.float() @ p.router.float()                 # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, sel = route(probs, k)

    # ---- auxiliary losses over the global token population ----
    t_glob = rt.psum_all(torch.full((), float(T), device=x.device))
    me = rt.psum_all(probs.sum(0)) / t_glob
    counts = torch.zeros(E, dtype=torch.float32, device=x.device)
    counts.index_add_(0, sel.reshape(-1),
                      torch.ones(T * k, dtype=torch.float32,
                                 device=x.device))
    ce = rt.psum_all(counts) / (t_glob * k)
    aux_lb = E * torch.sum(me * ce)
    aux_z = rt.psum_all(
        torch.sum(torch.logsumexp(logits, dim=-1) ** 2)) / t_glob

    # ---- dispatch into (E, cap, D) by index ----
    # (no boolean indexing: its nonzero would wait for the device)
    cap = _capacity(T, m)
    pos = queue_positions(sel, E)
    keep = pos < cap                                       # (T, k)
    slot = sel * cap + pos.clamp(max=cap - 1)              # (T, k)
    # a dropped choice is copied to one spare row past the E*cap slots
    dest = torch.where(keep, slot, E * cap).reshape(-1)
    xe = torch.zeros(E * cap + 1, D, dtype=x.dtype, device=x.device)
    xe = xe.index_copy(0, dest, ht[:, None].expand(T, k, D).reshape(-1, D))
    xe = xe[:E * cap].reshape(E, cap, D)

    # ---- expert parallelism over data ----
    ep = rt.comm.axis_size(DATA_AXIS)
    if E % ep:
        raise ValueError(f"experts {E} must divide over data axis {ep}")
    xe = rt.all_to_all_data(xe, split_axis=0, concat_axis=1)
    o = _expert_swiglu(rt, p, xe)                          # (E_l, ep*cap, D)
    o = rt.all_to_all_data(o, split_axis=1, concat_axis=0)  # (E, cap, D)

    # ---- combine: each kept choice's expert output times its gate ----
    picked = o.reshape(E * cap, D)[slot].float()           # (T, k, D)
    w = gates * keep.float()
    y = (picked * w[..., None]).sum(1)
    y = y.reshape(B, S, D).to(x.dtype)

    if m.shared_expert:
        y = y + (blocks.mlp_block(rt, p.shared, h, cfg) - h)

    return x + y, {"moe_lb": aux_lb, "moe_z": aux_z}
