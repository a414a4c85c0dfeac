"""The arithmetic of the bf16 paged kernels (B4 with split-KV, B6), emulated
in plain PyTorch on the CPU and held against the JAX Pallas kernels.

On bf16 inputs B4 and B6 run the tensor-core forward of
``src/repro_torch/csrc/flash_fwd.cuh`` over its paged K/V source. A 64-key
tile holds ``64 // page_size`` consecutive table entries (row r is slot
r % page_size of entry r // page_size); a row that holds no valid key (a
dead page, no page, a position at or past the row's limit) is zero-filled
and given a position past every query. Tiles whose valid positions allow
no visible pair are skipped. B4's live tiles are split over ``splits``
CTAs of 4 walking warps (2 at D = 128): walker j of splits * 4 takes live
tiles j, j + splits * 4, ...; each walker keeps an online softmax in log2
units (bf16 products summed in f32, P V with P as a bf16 hi/lo pair, each
tile's P V added as acc * alpha + pv), a CTA merges its warps in order and
the last CTA merges the CTAs in split order. B6 walks its live tiles in
one pass. ``emulated_paged`` does the same tile by tile; it must stay
within the 1e-4 bound of the bf16 kernels, with dead rows exact, against
``repro.kernels.paged_decode.paged_decode_attention`` and
``repro.kernels.paged_prefill.paged_prefill_attention`` run in interpret
mode on the same bf16-rounded inputs, for 1-8 splits.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_decode as jax_paged_decode
from repro.kernels import paged_prefill as jax_paged_prefill
from repro_torch.core.combine import NEG_INF
from repro_torch.kernels import paged_decode
from test_torch_fwd_split import DEAD, LN2, LOG2E, TOL, _bf16, _split
from test_torch_gpu import _assert_partials, _paged_pool_inputs

DECODE_CASES = {
    # B, Hq, Hkv, D, page_size, W, sp, rank, window, cache_len per row
    "page16_inactive_row": (3, 8, 2, 32, 16, 40, 1, 0, None, [620, 200, 0]),
    "page24_window300": (2, 4, 1, 80, 24, 30, 1, 0, 300, [700, 100]),
    "page8_sp2_rank1": (2, 8, 2, 64, 8, 40, 2, 1, None, [600, 77]),
    "window8_last_page_only": (1, 4, 1, 32, 16, 64, 1, 0, 8, [1000]),
    "d128": (2, 4, 1, 128, 16, 32, 1, 0, None, [500, 300]),
}

PREFILL_CASES = {
    # B, Sq, Hq, Hkv, D, page_size, W, sp, rank, window, cached_len per row
    "page16_nothing_cached": (2, 40, 8, 2, 80, 16, 24, 1, 0, None, [300, 0]),
    "d128_window_slid": (1, 48, 4, 1, 128, 16, 20, 1, 0, 40, [200]),
    "page4_sp2_rank1": (1, 24, 4, 2, 32, 4, 60, 2, 1, None, [260]),
}


def _key_tiles(tbl, n, lim_off, qlo, qhi, sp, rank, ps, window, pages_loc):
    """One row's 64-key tiles as the kernel builds them: per live tile its
    pool rows, key positions (past every query where a row holds no valid
    key) and validity; tiles whose valid positions allow no visible pair
    with the queries [qlo, qhi] are left out."""
    W = tbl.shape[0]
    ppt = 64 // ps
    limit = n + lim_off
    base = (np.arange(W) * sp + rank) * ps
    live_page = (tbl >= 0) & (tbl < pages_loc) & (base < limit)
    if window is not None:
        live_page &= qlo - (base + ps - 1) < window
    j, slot = np.arange(64) // ps, np.arange(64) % ps
    tiles = []
    for t in range(-(-W // ppt)):
        w = t * ppt + j
        wc = np.minimum(w, W - 1)
        pos = (w * sp + rank) * ps + slot
        valid = (j < ppt) & (w < W) & live_page[wc] & (pos < limit)
        if not valid.any():
            continue
        kmin, kmax = pos[valid].min(), pos[valid].max()
        if kmin > qhi or (window is not None and qlo - kmax >= window):
            continue
        tiles.append((np.where(valid, tbl[wc] * ps + slot, 0),
                      np.where(valid, pos, qhi + 1), valid))
    return tiles


def _walk(q, k, v, tiles, pos_q, window):
    """One walker's (m, l, acc) over its tiles: q (Sq,Hq,D), k/v the pool
    as (rows, Hkv, D) f32 tensors holding bf16 values."""
    Sq, Hq, D = q.shape
    G = Hq // k.shape[1]
    sl2 = np.float32(np.float32(1.0 / D ** 0.5) * LOG2E)
    m = torch.full((Hq, Sq), NEG_INF)
    l, acc = torch.zeros((Hq, Sq)), torch.zeros((Hq, Sq, D))
    for prow, pos, valid in tiles:
        ok = torch.from_numpy(valid)[:, None, None]
        kt, vt = (torch.where(ok, x[torch.from_numpy(prow)], 0.0)
                  .repeat_interleave(G, dim=1) for x in (k, v))
        pk = torch.from_numpy(pos)[None]
        vis = pk <= pos_q[:, None]
        if window is not None:
            vis &= pos_q[:, None] - pk < window
        s = torch.where(vis, torch.einsum("qhd,khd->hqk", q, kt) * sl2,
                        NEG_INF)
        m_cur = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(m_cur <= DEAD, 0.0, m_cur)
        alpha = torch.where(m <= DEAD, 0.0, torch.exp2(m - m_safe))
        p = torch.where(vis, torch.exp2(s - m_safe[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        pv = sum(torch.einsum("hqk,khd->hqd", x, vt) for x in _split(p))
        m, acc = m_cur, acc * alpha[..., None] + pv
    return m, l, acc


def _merge(states):
    """The kernel's merge of partial (m, l, acc) in order: a state with no
    visible key (m = -1e30, l = 0) weighs 0."""
    m = torch.stack([x[0] for x in states]).amax(0)
    m_safe = torch.where(m <= DEAD, 0.0, m)
    wt = [torch.where(x[0] <= DEAD, 0.0, torch.exp2(x[0] - m_safe))
          for x in states]
    return (m, sum(w * x[1] for w, x in zip(wt, states)),
            sum(w[..., None] * x[2] for w, x in zip(wt, states)))


def emulated_paged(q, pool_k, pool_v, tbl, lens, rank, *, sp, page_size,
                   window, decode, splits=1):
    """(o, lse) as the bf16 paged kernel computes them, from f32 tensors
    holding bf16 values: B4 (``decode``: keys p <= cache_len, ``splits``
    CTAs of 4 walking warps, 2 at D = 128) or B6 (p < cached_len, one
    walker)."""
    B, Sq, Hq, D = q.shape
    ps = page_size
    k, v = (x.reshape(-1, *x.shape[2:]) for x in (pool_k, pool_v))
    walkers = (2 if D > 80 else 4) if decode else 1
    o = torch.zeros((B, Sq, Hq, D))
    lse = torch.full((B, Hq, Sq), NEG_INF)
    for b in range(B):
        n = int(lens[b])
        pos_q = n + torch.arange(Sq)
        tiles = _key_tiles(tbl[b].numpy(), n, int(decode), n, n + Sq - 1,
                           sp, rank, ps, window, pool_k.shape[0])
        n_walk = splits * walkers
        states = [_walk(q[b], k, v, tiles[j::n_walk], pos_q, window)
                  for j in range(n_walk)]
        ctas = [_merge(states[s * walkers:(s + 1) * walkers])
                for s in range(splits)]
        m, l, acc = _merge(ctas) if splits > 1 else ctas[0]
        l_safe = torch.where(l == 0.0, 1.0, l)
        o[b] = (acc / l_safe[..., None]).transpose(0, 1)
        lse[b] = torch.where(m <= DEAD, NEG_INF, m * LN2 + torch.log(l_safe))
    return o, lse


@functools.lru_cache(maxsize=None)
def _case(kind, case):
    """bf16-rounded inputs of one case, the Pallas kernel on them
    (interpret mode) and the keyword arguments of both."""
    if kind == "decode":
        B, Hq, Hkv, D, ps, W, sp, rank, window, lens = DECODE_CASES[case]
        Sq, fn = 1, jax_paged_decode.paged_decode_attention
    else:
        B, Sq, Hq, Hkv, D, ps, W, sp, rank, window, lens = \
            PREFILL_CASES[case]
        fn = jax_paged_prefill.paged_prefill_attention
    arrs = list(_paged_pool_inputs(B, Sq, Hq, Hkv, D, ps, W, sp, rank, lens,
                                   kind == "decode"))
    arrs[:3] = [_bf16(x) for x in arrs[:3]]
    kw = dict(sp=sp, page_size=ps, window=window)
    want = fn(*(jnp.asarray(x) for x in arrs), jnp.int32(rank),
              interpret=True, **kw)
    return [torch.from_numpy(x) for x in arrs], rank, kw, \
        [np.asarray(w) for w in want]


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_split_kv_decode_matches_jax(case, splits):
    args, rank, kw, want = _case("decode", case)
    o, lse = emulated_paged(*args, rank, **kw, decode=True, splits=splits)
    _assert_partials(o.numpy(), lse.numpy(), *want, tol=TOL)
    for b, n in enumerate(DECODE_CASES[case][-1]):
        if n == 0:                                  # the inactive slot
            assert (lse[b] == NEG_INF).all() and (o[b] == 0).all()


@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_paged_prefill_tile_matches_jax(case):
    args, rank, kw, want = _case("prefill", case)
    o, lse = emulated_paged(*args, rank, **kw, decode=False)
    _assert_partials(o.numpy(), lse.numpy(), *want, tol=TOL)
    dead = want[1] <= DEAD
    lens = PREFILL_CASES[case][-1]
    if 0 in lens:                           # nothing cached: every row dead
        assert dead[lens.index(0)].all()
    if case == "d128_window_slid":
        assert dead.any() and not dead.all()


def test_decode_splits_fill_the_card():
    """At the engine's batch of 4 (32 (row, kv head) pairs on 132 SMs) the
    split count fills the card in one wave of CTAs unless the table has too
    few tiles to give every walking warp one."""
    assert paged_decode.decode_splits(4, 8, 80, 128, 16, 132) == 4
    assert paged_decode.decode_splits(4, 8, 128, 64, 16, 132) == 4
    assert paged_decode.decode_splits(1, 1, 80, 8, 16, 132) == 1
    assert paged_decode.decode_splits(1, 1, 80, 40, 16, 132) == 3
    assert paged_decode.decode_splits(3, 8, 80, 128, 24, 132) == 5
    assert paged_decode.decode_splits(64, 8, 80, 128, 16, 132) == 1
