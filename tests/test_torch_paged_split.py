"""The arithmetic of the bf16 paged kernels (B4 with split-KV, B6), emulated
in plain PyTorch on the CPU and held against the JAX Pallas kernels.

On bf16 inputs B4 and B6 run the tensor-core forward of
``src/repro_torch/csrc/flash_fwd.cuh`` over its paged K/V source. Pages of
up to 64 keys: a 64-key tile holds ``64 // page_size`` consecutive table
entries (row r is slot r % page_size of entry r // page_size); larger
pages span ``ceil(page_size / 64)`` tiles, each a 64-row slice of the page
(rows past its end hold no key). A row that holds no valid key (a dead
page, no page, a position at or past the row's limit) is zero-filled and
given a position past every query. Tiles whose valid positions allow no
visible pair are skipped. The key tiles go in chunks (``_chunk_tiles``:
at most 4096 tiles reading at most 2048 table entries), whose entries
and flags the kernel holds at once. B4's live tiles are split
over ``splits`` CTAs of 4 walking warps (2 at D = 128 and 256): walker j
of splits * 4 takes each chunk's live tiles j, j + splits * 4, ...; each
walker keeps an online softmax in log2 units (bf16 products summed in f32,
P V with P as a bf16 hi/lo pair, each tile's P V added as acc * alpha +
pv), a CTA merges its warps in order and the last CTA merges the CTAs in
split order. Above D = 128 the output's D is split over CTAs of 128
columns, each computing the whole S and its own columns of P V and
merging its own partials. With G > 16 query heads a group, B4 runs
unsplit (one walker), as B6 does, which walks its live tiles in one
pass. ``emulated_paged`` does the same tile by tile;
it must stay within the 1e-4 bound of the bf16 kernels, with dead rows
exact, against ``repro.kernels.paged_decode.paged_decode_attention`` and
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
    # GPT-3B's head size and MHA (one query head a group), two D slices
    "d256_mha": (2, 2, 2, 256, 16, 24, 1, 0, None, [300, 130]),
    # pages of 128: two tiles a page; the window starts inside page 3
    "page128_window300": (2, 4, 1, 32, 128, 8, 1, 0, 300, [700, 100]),
    "page96_sp2_rank1": (2, 8, 2, 64, 96, 6, 2, 1, None, [900, 77]),
    # 32 query heads on one kv head: the unsplit route
    "g32_inactive_row": (2, 32, 1, 32, 16, 24, 1, 0, None, [300, 0]),
}

PREFILL_CASES = {
    # B, Sq, Hq, Hkv, D, page_size, W, sp, rank, window, cached_len per row
    "page16_nothing_cached": (2, 40, 8, 2, 80, 16, 24, 1, 0, None, [300, 0]),
    "d128_window_slid": (1, 48, 4, 1, 128, 16, 20, 1, 0, 40, [200]),
    "page4_sp2_rank1": (1, 24, 4, 2, 32, 4, 60, 2, 1, None, [260]),
    "d256": (1, 40, 4, 2, 256, 16, 20, 1, 0, None, [200]),
    # queries 300..347 in a window of 40, which starts inside page 2: the
    # later ones see no key
    "page128_window_slid": (1, 48, 4, 1, 32, 128, 4, 1, 0, 40, [300]),
    "page96_nothing_cached": (2, 20, 8, 2, 32, 96, 6, 1, 0, None, [300, 0]),
    "page48_sp2_rank1": (1, 24, 4, 2, 32, 48, 10, 2, 1, None, [260]),
}


def _chunk_tiles(ps):
    """Key tiles a chunk (csrc/flash_fwd.cuh: paged_chunk_tiles): at most
    4096, reading at most 2048 table entries."""
    if ps <= 64:
        return min(4096, 2048 // (64 // ps))
    return min(4096, 2047 * -(-ps // 64))


def _key_tiles(tbl, n, lim_off, qlo, qhi, sp, rank, ps, window, pages_loc):
    """One row's 64-key tiles as the kernel builds them: per live tile its
    index, pool rows, key positions (past every query where a row holds no
    valid key) and validity; tiles whose valid positions allow no visible
    pair with the queries [qlo, qhi] are left out."""
    W = tbl.shape[0]
    limit = n + lim_off
    base = (np.arange(W) * sp + rank) * ps
    live_page = (tbl >= 0) & (tbl < pages_loc) & (base < limit)
    if window is not None:
        live_page &= qlo - (base + ps - 1) < window
    r = np.arange(64)
    tiles = []
    for t in range(paged_decode.key_tiles(W, ps)):
        if ps <= 64:                 # 64 // ps whole pages a tile
            ppt = 64 // ps
            w, slot = t * ppt + r // ps, r % ps
            in_page = r // ps < ppt
        else:                        # a 64-row slice of one page
            tpp = -(-ps // 64)
            w, slot = np.full(64, t // tpp), (t % tpp) * 64 + r
            in_page = slot < ps
        wc = np.minimum(w, W - 1)
        pos = (w * sp + rank) * ps + slot
        valid = in_page & (w < W) & live_page[wc] & (pos < limit)
        if not valid.any():
            continue
        kmin, kmax = pos[valid].min(), pos[valid].max()
        if kmin > qhi or (window is not None and qlo - kmax >= window):
            continue
        tiles.append((t, np.where(valid, tbl[wc] * ps + slot, 0),
                      np.where(valid, pos, qhi + 1), valid))
    return tiles


def _walk(q, k, v, tiles, pos_q, window):
    """One walker's (m, l, acc) over its tiles: q (Sq,Hq,D), k/v the pool
    as (rows, Hkv, DV) f32 tensors holding bf16 values, DV the CTA's
    columns of V (S over all of q's and k's D)."""
    Sq, Hq, D = q.shape
    DV = v.shape[-1]
    G = Hq // k.shape[1]
    sl2 = np.float32(np.float32(1.0 / D ** 0.5) * LOG2E)
    m = torch.full((Hq, Sq), NEG_INF)
    l, acc = torch.zeros((Hq, Sq)), torch.zeros((Hq, Sq, DV))
    for _, prow, pos, valid in tiles:
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
                   window, decode, splits=1, chunk=None):
    """(o, lse) as the bf16 paged kernel computes them, from f32 tensors
    holding bf16 values: B4 (``decode``: keys p <= cache_len, ``splits``
    CTAs of 4 walking warps, 2 at D = 128 and 256; with G > 16 one walker
    and no split) or B6 (p < cached_len, one walker), the live tiles of
    each ``chunk`` key tiles (default ``_chunk_tiles``) dealt to the walkers
    afresh. Above D = 128 each
    128-column slice of the output is its own CTA (of each split), whose
    (m, l) every slice computes alike; the first slice's lse is kept."""
    B, Sq, Hq, D = q.shape
    ps = page_size
    chunk = chunk or _chunk_tiles(ps)
    k, v = (x.reshape(-1, *x.shape[2:]) for x in (pool_k, pool_v))
    unsplit = not decode or Hq // pool_k.shape[2] > 16
    walkers = 1 if unsplit else (2 if D > 80 else 4)
    splits = 1 if unsplit else splits
    dv = 128 if D > 128 else D
    o = torch.zeros((B, Sq, Hq, D))
    lse = torch.full((B, Hq, Sq), NEG_INF)
    for b in range(B):
        n = int(lens[b])
        pos_q = n + torch.arange(Sq)
        tiles = _key_tiles(tbl[b].numpy(), n, int(decode), n, n + Sq - 1,
                           sp, rank, ps, window, pool_k.shape[0])
        n_walk = splits * walkers
        for d0 in range(D - dv, -1, -dv):    # the first slice last: its lse
            vs = v[..., d0:d0 + dv]
            states = [_walk(q[b], k, vs, _deal(tiles, j, n_walk, chunk),
                            pos_q, window) for j in range(n_walk)]
            ctas = [_merge(states[s * walkers:(s + 1) * walkers])
                    for s in range(splits)]
            m, l, acc = _merge(ctas) if splits > 1 else ctas[0]
            l_safe = torch.where(l == 0.0, 1.0, l)
            o[b, ..., d0:d0 + dv] = (acc / l_safe[..., None]).transpose(0, 1)
            lse[b] = torch.where(m <= DEAD, NEG_INF,
                                 m * LN2 + torch.log(l_safe))
    return o, lse


def _deal(tiles, j, n_walk, chunk):
    """Walker j's live tiles: j, j + n_walk, ... of each chunk."""
    out = []
    for c in sorted({x[0] // chunk for x in tiles}):
        out += [x for x in tiles if x[0] // chunk == c][j::n_walk]
    return out


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


@pytest.mark.parametrize("case", ["d256_mha", "page128_window300",
                                  "page16_inactive_row"])
def test_split_kv_decode_in_key_chunks_matches_jax(case):
    """The chunked walk (each chunk's live tiles dealt to the walkers
    afresh), here at chunks of 3 tiles, as the kernel deals them past
    ``_chunk_tiles``: within the bf16 bound of the Pallas kernel."""
    args, rank, kw, want = _case("decode", case)
    o, lse = emulated_paged(*args, rank, **kw, decode=True, splits=2,
                            chunk=3)
    _assert_partials(o.numpy(), lse.numpy(), *want, tol=TOL)


@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_paged_prefill_tile_matches_jax(case):
    args, rank, kw, want = _case("prefill", case)
    o, lse = emulated_paged(*args, rank, **kw, decode=False)
    _assert_partials(o.numpy(), lse.numpy(), *want, tol=TOL)
    dead = want[1] <= DEAD
    lens = PREFILL_CASES[case][-1]
    if 0 in lens:                           # nothing cached: every row dead
        assert dead[lens.index(0)].all()
    if "window_slid" in case:
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
    # head size 256: two CTAs over D for each (row, kv head) and split;
    # GPT-3B's 12 kv heads at batch 4 fill 96 of the SMs already
    assert paged_decode.decode_splits(4, 12, 256, 128, 16, 132) == 1
    assert paged_decode.decode_splits(1, 2, 256, 64, 16, 132) == 8
    # pages of 128: two 64-key tiles a page
    assert paged_decode.key_tiles(8, 128) == 16
    assert paged_decode.key_tiles(7, 96) == 14
    assert paged_decode.key_tiles(10, 24) == 5
    assert paged_decode.decode_splits(1, 1, 80, 4, 128, 132) == 2
