"""The contiguous serving cache of the static-batch path (the port's
counterpart of ``repro.serve.kv_cache``).

Layouts, per rank (JAX ``kv_cache.py:34-64``):

  attention : k, v (B, S_local, Hkv, hd)   the rank's contiguous slice
  mamba     : conv (B, d_conv - 1, d_inner) the last raw conv inputs, in
              the param dtype; state (B, Hm, N, P) f32
  mlstm     : state (B, H, dk, dk + 1) f32
  slstm     : h, c (B, H, dh) f32

Recurrent states have no sequence dimension: every SP rank holds the
same, and only the batch splits over data replicas. An all-attention
stack (dense, MoE) keeps every layer's K and V in one tensor each,

    k, v : (num_layers, B, S_local, Hkv, hd)

a stack with a recurrent mixer (xLSTM, and jamba's Mamba layers beside
its attention layers) a list of per-layer dicts. An encoder-decoder's
cache is its decoder's stacked {'k','v'} plus

    enc_out : (B, S_enc_local, D)   the rank's contiguous slice of the
                                    encoder output

at the encoder's own length: the JAX cache holds ``enc_out`` at the
decoder's capacity (``repro/serve/kv_cache.py:90-92``), and its
unmasked cross decode gives the zero rows past the encoder's length
softmax weight, which the port's does not. Only this
module reads the difference: ``from_layers`` builds either from per-layer
dicts, ``layer(cache, i)`` gives layer ``i``'s dict of either (views of
the stacked tensors), ``kv_stacks`` a stacked cache's two tensors.
The K/V slices are those of a capacity-sized cache (``capacity`` a
multiple of the SP degree): slot ``s`` of rank ``r`` holds position
``r * S_local + s``; a decode step treats positions ``<= cache_len`` as
filled and writes the new token at ``cache_len`` on its owning rank.
``write_token`` and the decode steps update the cache **in place**.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import torch

from repro_torch.configs.base import MambaConfig, ModelConfig
from repro_torch.models import spec, transformer

Cache = Union[Dict[str, torch.Tensor], List[Dict[str, torch.Tensor]]]


def stacked(cfg: ModelConfig) -> bool:
    """Whether ``cfg``'s cache is the stacked {'k','v'} of an
    all-attention stack."""
    return all(m == "attn" for m, _ in transformer.layer_pattern(cfg))


def _layer_cache(cfg: ModelConfig, mixer: str, batch: int, s_local: int,
                 dtype, device) -> Dict[str, torch.Tensor]:
    d, hq = cfg.d_model, cfg.num_heads
    if mixer == "attn":
        shape = (batch, s_local, cfg.num_kv_heads, cfg.head_dim_)
        return {n: torch.zeros(shape, dtype=dtype, device=device)
                for n in ("k", "v")}
    if mixer == "mamba":
        m = cfg.mamba or MambaConfig()
        di = m.expand * d
        return {"conv": torch.zeros((batch, m.d_conv - 1, di), dtype=dtype,
                                    device=device),
                "state": torch.zeros((batch, di // m.head_dim, m.d_state,
                                      m.head_dim), dtype=torch.float32,
                                     device=device)}
    dk = d // hq
    if mixer == "mlstm":
        return {"state": torch.zeros((batch, hq, dk, dk + 1),
                                     dtype=torch.float32, device=device)}
    return {n: torch.zeros((batch, hq, dk), dtype=torch.float32,
                           device=device) for n in ("h", "c")}


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               device, enc_len: Optional[int] = None) -> Cache:
    """A zeroed cache of ``batch`` rows whose K/V hold ``capacity``
    positions: {'k','v'} (L, batch, capacity, Hkv, hd) for an
    all-attention stack, else one dict a layer (module doc); an
    encoder-decoder's also holds ``enc_out`` (batch, enc_len, D), where
    ``enc_len`` (the encoder's length on this rank) must be given."""
    dtype = spec.DTYPES[cfg.param_dtype]
    if stacked(cfg):
        shape = (cfg.num_layers, batch, capacity, cfg.num_kv_heads,
                 cfg.head_dim_)
        cache = {n: torch.zeros(shape, dtype=dtype, device=device)
                 for n in ("k", "v")}
        if cfg.encdec:
            if enc_len is None:
                raise ValueError(f"{cfg.name}: an encoder-decoder cache "
                                 "needs the encoder's length (enc_len)")
            cache["enc_out"] = torch.zeros((batch, enc_len, cfg.d_model),
                                           dtype=dtype, device=device)
        return cache
    return [_layer_cache(cfg, mixer, batch, capacity, dtype, device)
            for mixer, _ in transformer.layer_plan(cfg)]


def from_layers(cfg: ModelConfig,
                layers: Sequence[Dict[str, torch.Tensor]]) -> Cache:
    """The cache of ``cfg`` made of one dict a layer (module doc): the
    layers' K/V stacked for an all-attention stack, else the list."""
    if stacked(cfg):
        return {n: torch.stack([c[n] for c in layers]) for n in ("k", "v")}
    return list(layers)


def kv_stacks(cache: Cache):
    """(k, v), the (L, B, S_local, Hkv, hd) tensors of an all-attention
    stack's cache."""
    if isinstance(cache, list):
        raise TypeError("a cache with recurrent layers has no K/V stacks")
    return cache["k"], cache["v"]


def layer(cache: Cache, i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s dict of ``cache`` (stacked leaves give views, so
    writes land in the cache); also a page pool's {'k','v'} stacks."""
    if isinstance(cache, list):
        return cache[i]
    return {n: cache[n][i] for n in ("k", "v")}


def fill_from_prefill(cfg: ModelConfig, dst: Sequence[Cache],
                      src: Sequence[Cache], prompt_len: int,
                      ranks: Optional[Sequence[int]] = None) -> None:
    """Copy the prefill caches ``src`` of one data replica's SP ranks, in
    SP rank order (each rank's slice of ``prompt_len`` positions), into
    the capacity-sized caches ``dst`` of the SP ranks ``ranks`` (default:
    all of them, in order), in place: the prompt's K/V at positions
    ``0 .. prompt_len - 1`` of the capacity layout, and each recurrent
    state as it is (JAX ``_legacy_main``'s ``merge``)."""
    ranks = range(len(dst)) if ranks is None else ranks
    for i, (mixer, _) in enumerate(transformer.layer_plan(cfg)):
        if mixer != "attn":
            for j, d in zip(ranks, dst):
                for n, t in layer(d, i).items():
                    t.copy_(layer(src[j], i)[n])
            continue
        for n in ("k", "v"):
            full = torch.cat([layer(s, i)[n] for s in src], dim=1)
            s_cap = layer(dst[0], i)[n].shape[1]
            for j, d in zip(ranks, dst):
                lo = j * s_cap
                m = max(0, min(s_cap, prompt_len - lo))
                if m:
                    layer(d, i)[n][:, :m] = full[:, lo:lo + m]


def gather_prefill(rt, cfg: ModelConfig, cache: Cache) -> List[Cache]:
    """Every SP rank's prefill cache of this rank's data replica, in SP
    rank order, from this rank's ``cache`` (a rank process's view for
    ``fill_from_prefill``): each attention layer's K/V all-gathered over
    the SP axes and cut back into the ranks' slices; a recurrent state is
    this rank's in every entry (``fill_from_prefill`` copies each rank's
    own)."""
    p = rt.sp_size()
    if isinstance(cache, dict):
        parts = {n: rt.all_gather_model(t, axis=2).chunk(p, 2)
                 for n, t in cache.items() if n in ("k", "v")}
        return [dict(cache, **{n: parts[n][j] for n in parts})
                for j in range(p)]
    layers = []
    for (mixer, _), c in zip(transformer.layer_plan(cfg), cache):
        if mixer != "attn":
            layers.append([c] * p)
            continue
        parts = {n: rt.all_gather_model(t, axis=1).chunk(p, 1)
                 for n, t in c.items()}
        layers.append([{n: parts[n][j] for n in parts} for j in range(p)])
    return [[lay[j] for lay in layers] for j in range(p)]


def write_token(rt, cache: Dict[str, torch.Tensor], k_new, v_new,
                cache_len: torch.Tensor) -> None:
    """Write each row's new token at position ``cache_len`` into its owning
    rank's slot, **in place**, without a host sync.

    cache: {'k','v'} one layer's slices (B, S_local, Hkv, hd); k_new /
    v_new: (B, 1, Hkv, hd); cache_len: (B,) int device tensor.
    """
    s_loc = cache["k"].shape[1]
    slot = cache_len.long() - rt.sp_rank() * s_loc
    own = ((slot >= 0) & (slot < s_loc))[:, None, None]
    slot = slot.clamp(0, s_loc - 1)
    rows = torch.arange(slot.shape[0], device=slot.device)
    for name, new in (("k", k_new), ("v", v_new)):
        t = cache[name]
        t[rows, slot] = torch.where(own, new[:, 0].to(t.dtype), t[rows, slot])

