"""The arithmetic of the bf16 tensor-core forward (B1, B2, B5), emulated in
plain PyTorch on the CPU and held against the JAX Pallas forward.

On bf16 inputs the kernel of ``src/repro_torch/csrc/flash_fwd.cuh``
(``flash_fwd_mma``) multiplies on the tensor cores: q k^T is an exact
product of bf16 values summed in f32, scaled by scale * log2 e and
exponentiated with exp2 (the running max m in those log2 units, so
lse = m ln 2 + log l); p, which is f32, enters P V as a bf16 hi/lo pair
(hi = bf16(p), lo = bf16(p - hi), two MMAs); l sums the f32 p; each
64-key tile's P V is summed apart and added as acc = acc * alpha + pv;
when a CTA's live rows fit 16 (Sq * G <= 16, B1 and B5) its warps take
every 4th tile and their states are merged at the end. ``emulated_fwd``
does the same in f32 on the CPU, tile by tile. It must stay within the
1e-4 bound of the bf16 forward, with dead rows exact, against
``repro.kernels.flash_attention.flash_attention_fwd`` (with and without the
running accumulator) and ``repro.kernels.ragged_prefill.ragged_prefill_fwd``
run in interpret mode on the same bf16-rounded inputs, for every case of
``MMA_FWD_CASES`` (the card's tensor-core cases). One bf16 rounding of P
(no lo) misses that bound. Closeness, not bit-identity: the JAX
single-tile bit-identity tests fail on this jax. The emulation sums in f32
with rounding to nearest; the tensor cores' accumulation truncates, which
only the card shows (``tests/test_torch_gpu.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash
from repro.kernels import ragged_prefill as jax_ragged
from repro_torch.core.combine import NEG_INF, combine_pair
from repro_torch.kernels import ref
from test_torch_gpu import (FWD_ROUTES, MMA_FWD_CASES, _assert_partials,
                            _mma_fwd_inputs)

LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)
DEAD = NEG_INF / 2
TOL = 1e-4                  # the bf16 forward's bound on the card


def _split(x):
    """x as a bf16 hi/lo pair, each returned in f32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def emulated_fwd(q, k, v, pos_q, pos_k, o_acc=None, lse_acc=None, *, causal,
                 window, prefix_len=None, split=True):
    """(o, lse) as the tensor-core kernel computes them: f32 tensors holding
    bf16 values in, f32 sums, 64-key tiles, P as a hi/lo pair (or, with
    ``split=False``, one bf16 rounding of P)."""
    B, Sq, Hq, D = q.shape
    Sk = k.shape[1]
    G = Hq // k.shape[2]
    sl2 = np.float32(np.float32(1.0 / D ** 0.5) * LOG2E)
    kx, vx = (t.repeat_interleave(G, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, kx) * sl2
    mask = ref.make_mask(pos_q, pos_k, causal=causal, window=window,
                         prefix_len=prefix_len)
    if mask is None:                # no mask: every pair visible
        mask = torch.ones((Sq, Sk), dtype=torch.bool)
    mask = (mask[None, None] if mask.dim() == 2 else mask[:, None]).expand(
        B, Hq, Sq, Sk)
    s = torch.where(mask, s, NEG_INF)
    # Sq * G <= 16 without an accumulator: the keys are split over 4 (2 at
    # D = 128) partial states, tile t into state t % n, merged at the end
    n = (2 if D > 80 else 4) if Sq * G <= 16 and o_acc is None else 1
    states = [(torch.full((B, Hq, Sq), NEG_INF), torch.zeros((B, Hq, Sq)),
               torch.zeros((B, Hq, Sq, D))) for _ in range(n)]
    for t, k0 in enumerate(range(0, Sk, 64)):
        m, l, acc = states[t % n]
        st, mt = s[..., k0:k0 + 64], mask[..., k0:k0 + 64]
        vt = vx[:, k0:k0 + 64]
        m_cur = torch.maximum(m, st.amax(-1))
        m_safe = torch.where(m_cur <= DEAD, 0.0, m_cur)
        alpha = torch.where(m <= DEAD, 0.0, torch.exp2(m - m_safe))
        p = torch.where(mt, torch.exp2(st - m_safe[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        parts = _split(p) if split else (p.to(torch.bfloat16).float(),)
        pv = sum(torch.einsum("bhqk,bkhd->bhqd", x, vt) for x in parts)
        states[t % n] = (m_cur, l, acc * alpha[..., None] + pv)
    m = torch.stack([x[0] for x in states]).amax(0)
    m_safe = torch.where(m <= DEAD, 0.0, m)
    wt = [torch.where(x[0] <= DEAD, 0.0, torch.exp2(x[0] - m_safe))
          for x in states]
    l = sum(w * x[1] for w, x in zip(wt, states))
    acc = sum(w[..., None] * x[2] for w, x in zip(wt, states))
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = (acc / l_safe[..., None]).transpose(1, 2)
    lse = torch.where(m <= DEAD, NEG_INF, m * LN2 + torch.log(l_safe))
    if o_acc is not None:
        return combine_pair(o_acc, lse_acc, o, lse)
    return o, lse


def _bf16(x):
    return torch.from_numpy(x).bfloat16().float().numpy()


def _case(case, route):
    """bf16-rounded inputs of one case, the JAX forward on them (interpret
    mode) and the keyword arguments of both."""
    B, Sq, Sk, Hq, Hkv, D, causal, window, kind = MMA_FWD_CASES[case]
    arrs = list(_mma_fwd_inputs(route, B, Sq, Sk, Hq, Hkv, D, kind))
    arrs[:3] = [_bf16(x) for x in arrs[:3]]
    arrs = [x for x in arrs if x is not None]
    kw = dict(causal=causal, window=window)
    blk = dict(block_q=arrs[0].shape[1], block_k=arrs[1].shape[1],
               interpret=True)
    fn = jax_ragged.ragged_prefill_fwd if route.startswith("B5") \
        else jax_flash.flash_attention_fwd
    want = fn(*(jnp.asarray(x) for x in arrs), **kw, **blk)
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in arrs], kw, \
        [np.asarray(w) for w in want]


@pytest.mark.parametrize("route", FWD_ROUTES)
@pytest.mark.parametrize("case", sorted(MMA_FWD_CASES))
def test_split_fwd_matches_jax(case, route):
    args, kw, want = _case(case, route)
    o, lse = emulated_fwd(*args, **kw)
    _assert_partials(o.numpy(), lse.numpy(), *want, tol=TOL)
    if route == "B5_lengths":       # the zero-length row
        assert (lse[2] == NEG_INF).all() and (o[2] == 0).all()
    if MMA_FWD_CASES[case][-1] == "future" and route == "B1":
        assert (want[1] <= DEAD).any()              # there are dead rows


def test_single_bf16_p_misses_the_bound():
    """Without lo, P V carries p to 2^-9 of its size: o moves ~1e-3 on
    short rows, past the 1e-4 bound that the pair keeps."""
    args, kw, want = _case("d32_g4_dead_rows", "B1")
    o, _ = emulated_fwd(*args, **kw, split=False)
    err = np.abs(o.numpy() - want[0]) - TOL * np.abs(want[0])
    assert err.max() > TOL
