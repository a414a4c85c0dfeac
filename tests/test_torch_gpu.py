"""repro_torch's CUDA kernels vs their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips from inside the
``cuda_device`` fixture when ``torch.cuda.is_available()`` is false (never
at import or collection, so every pytest-xdist worker collects the same
tests). The file imports no JAX: the machine with the card has none. Run on
the card with ``python -m pytest -q -m gpu tests/test_torch_gpu.py``.

The case tables and input builders are shared with
``tests/test_torch_kernels.py`` (B1-B4, B7), ``tests/test_torch_legacy.py``
(B5) and ``tests/test_torch_prefix.py`` (B6), which hold the plain versions
against the JAX Pallas kernels on the CPU. Tolerances: forward 2e-5 for f32
inputs (the JAX kernel tests' own), 1e-4 for bf16 inputs upcast to f32 in
both versions (only the summation order differs); backward (B3, B7) 3e-4,
the JAX ``test_bwd_matches_ref`` bound; dead rows exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import startrail as st_torch
from repro_torch.core.combine import NEG_INF
from repro_torch.kernels import (flash_attention, paged_decode,
                                 paged_prefill, ragged_bwd, ragged_prefill)

TOL = 2e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _zigzag(rank, n, p):
    return st_torch.shard_positions(rank, n, p, "zigzag").numpy()


def _assert_partials(o, lse, o_ref, lse_ref, tol=TOL):
    o, lse = np.asarray(o), np.asarray(lse)
    o_ref, lse_ref = np.asarray(o_ref), np.asarray(lse_ref)
    np.testing.assert_allclose(o, o_ref, atol=tol, rtol=tol)
    live = lse_ref > NEG_INF / 2
    np.testing.assert_allclose(lse[live], lse_ref[live], atol=tol, rtol=tol)
    # dead rows: exact zeros and exactly NEG_INF
    assert (lse[~live] == np.float32(NEG_INF)).all()
    dead_o = np.swapaxes(~live, 1, 2)                  # (B, S, H)
    assert (o[dead_o] == 0.0).all()


FWD_CASES = {
    # B, S, Hq, Hkv, D, causal, window, positions, blk
    "mha_causal_d16": (2, 64, 2, 2, 16, True, None, "arange", 32),
    "gqa_window_d80": (1, 64, 8, 2, 80, True, 24, "arange", 32),
    "gqa_full_d16": (1, 64, 8, 2, 16, False, None, "arange", 32),
    "dead_rows": (1, 64, 4, 1, 16, True, None, "future", 32),
    "zigzag_gqa": (1, 64, 8, 2, 80, True, 40, "zigzag", 32),
    # head size 128, MHA (deepseek-7b, GPT-7B)
    "mha_causal_d128": (1, 64, 4, 4, 128, True, None, "arange", 32),
    # head size 256, 8 query heads on one kv head (paligemma-3b)
    "mqa_g8_d256": (1, 64, 8, 1, 256, True, None, "arange", 32),
}


def _fwd_inputs(B, S, Hq, Hkv, D, kind, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    ar = np.arange(S, dtype=np.int32)
    if kind == "arange":
        pos_q, pos_k = ar, ar
    elif kind == "future":
        # the first half of the query rows see no key at all
        pos_q, pos_k = ar, ar + S // 2
    else:
        pos_q, pos_k = _zigzag(1, 2 * S, 2), _zigzag(0, 2 * S, 2)
    return q, k, v, pos_q.astype(np.int32), pos_k.astype(np.int32)


PAGED_CASES = {
    # B, Hq, Hkv, D, ps, W, sp, rank, window
    "mha_d16": (3, 2, 2, 16, 4, 4, 1, 0, None),
    "gqa_d80": (3, 8, 2, 80, 4, 4, 1, 0, None),
    "gqa_window": (3, 8, 2, 16, 4, 5, 1, 0, 6),
    "sp2_rank1": (3, 8, 2, 80, 4, 3, 2, 1, None),
    "sp2_rank1_window": (3, 4, 1, 16, 4, 3, 2, 1, 7),
    # head size 128, 4 query heads per kv head (minitron-8b)
    "gqa4_d128": (3, 8, 2, 128, 4, 4, 1, 0, None),
    # head size 256, MHA (GPT-3B)
    "mha_d256": (3, 4, 4, 256, 16, 4, 1, 0, None),
    # pages of 128 (two key tiles each) under a window that starts inside
    # a page; pages of 96 on rank 1 of 2
    "page128_window": (3, 8, 2, 32, 128, 3, 1, 0, 100),
    "page96_sp2_rank1": (3, 4, 1, 64, 96, 3, 2, 1, None),
    # 32 query heads on one kv head: more than one 16-row slab
    "g32": (3, 32, 1, 32, 16, 4, 1, 0, None),
}


def _paged_inputs(B, Hq, Hkv, D, ps, W, sp, seed=0):
    rng = np.random.default_rng(seed)
    pages_loc = 8
    pool_k = rng.normal(size=(pages_loc, ps, Hkv, D)).astype(np.float32)
    pool_v = rng.normal(size=(pages_loc, ps, Hkv, D)).astype(np.float32)
    q = rng.normal(size=(B, 1, Hq, D)).astype(np.float32)
    tbl = rng.integers(0, pages_loc, size=(B, W)).astype(np.int32)
    tbl[0, -1] = -1                                  # unallocated tail page
    # row 0: a partial last page; row 1: anywhere
    cl = np.array([(W * sp - 2) * ps + ps // 2,
                   rng.integers(0, W * sp * ps)] + [0] * (B - 2), np.int32)
    tbl[-1] = -1                                     # an inactive slot
    cl[-1] = 0
    return q, pool_k, pool_v, tbl, cl


RAGGED_CASES = {
    # B, Sq, Sk, Hq, Hkv, D, window, positions
    # per-row lengths 64, 37, 0 (the last row sees no key at all)
    "ragged_rows": (3, 64, 64, 8, 2, 80, None, "lengths"),
    # the static-batch decode shape: one query per row at its cache length
    "decode_sq1": (4, 1, 96, 8, 2, 80, None, "decode"),
    "window": (2, 64, 64, 4, 1, 16, 24, "lengths"),
    # each row a sequence starting at its own position
    "offset_rows": (3, 40, 72, 4, 4, 16, 30, "offset"),
    "decode_d128": (4, 1, 96, 8, 2, 128, None, "decode"),
    # paligemma-3b's --legacy decode: 8 query heads on one kv head of 256
    "decode_g8_d256": (4, 1, 96, 8, 1, 256, None, "decode"),
}


def _ragged_inputs(B, Sq, Sk, Hq, Hkv, D, kind, seed=0):
    """q, k, v and per-row positions pos_q (B,Sq), pos_k (B,Sk): validity
    is positional (a key pushed past every query is never seen)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    ak = np.arange(Sk, dtype=np.int32)[None]
    if kind == "lengths":
        lens = np.array([Sk, 37, 0][:B] + [Sk] * (B - 3))[:, None]
        pos_q = np.broadcast_to(np.arange(Sq, dtype=np.int32), (B, Sq))
        pos_k = np.where(ak < lens, ak, Sq + Sk)
    elif kind == "decode":
        cl = np.array([Sk - 1, 50, 10, 0][:B])[:, None]
        pos_q = cl
        pos_k = np.where(ak <= cl, ak, cl + 1)
    else:
        start = 17 * np.arange(B)[:, None]
        pos_q = start + (Sk - Sq) + np.arange(Sq, dtype=np.int32)[None]
        pos_k = start + ak
    return (q, k, v, np.ascontiguousarray(pos_q, dtype=np.int32),
            np.ascontiguousarray(pos_k, dtype=np.int32))


PAGED_PREFILL_CASES = {
    # B, Sq, Hq, Hkv, D, ps, W, sp, rank, window, cached_len per row
    # row 1 has no cached prefix (every row dead); row 0's last cached page
    # is partly filled
    "gqa_d80": (3, 20, 8, 2, 80, 4, 6, 1, 0, None, [13, 0, 20]),
    "mha_d16": (2, 9, 2, 2, 16, 4, 5, 1, 0, None, [16, 7]),
    # queries at 20.. see only keys inside a window of 6: the window slides
    # past the whole prefix for the later rows
    "window_slid": (2, 12, 4, 1, 16, 4, 6, 1, 0, 6, [20, 8]),
    "sp2_rank1": (2, 10, 8, 2, 80, 4, 4, 2, 1, None, [24, 9]),
    "gqa_d128": (3, 20, 8, 2, 128, 4, 6, 1, 0, None, [13, 0, 20]),
    "mqa_d256": (2, 20, 4, 1, 256, 16, 4, 1, 0, None, [40, 0]),
    # pages of 128 with row 0's page 1 a hole: queries 200..239 in a window
    # of 100 see keys 100..127 of page 0 until the window slides past it
    "page128_window_slid": (2, 40, 4, 1, 32, 128, 3, 1, 0, 100, [200, 0]),
    "page96": (2, 12, 4, 2, 32, 96, 3, 1, 0, None, [150, 0]),
    "page48_sp2_rank1": (2, 10, 4, 2, 32, 48, 4, 2, 1, None, [200, 60]),
}


def _paged_prefill_inputs(B, Sq, Hq, Hkv, D, ps, W, sp, rank, cached_len,
                          seed=0):
    """q, pools, table and cached_len: row b's table holds distinct pages
    for the blocks this rank owns below cached_len[b] plus one suffix page,
    and -1 past them; row 0 also has an unallocated hole."""
    rng = np.random.default_rng(seed)
    pages_loc = B * W
    pool_k = rng.normal(size=(pages_loc, ps, Hkv, D)).astype(np.float32)
    pool_v = rng.normal(size=(pages_loc, ps, Hkv, D)).astype(np.float32)
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    perm = rng.permutation(pages_loc)
    tbl = np.full((B, W), -1, np.int32)
    for b, cl in enumerate(cached_len):
        blocks = -(-cl // ps) + 1
        n_local = min(W, (blocks - rank + sp - 1) // sp)
        tbl[b, :n_local] = perm[b * W:b * W + n_local]
    tbl[0, 1] = -1                                   # unallocated hole
    return q, pool_k, pool_v, tbl, np.asarray(cached_len, np.int32)


BWD_TOL = 3e-4

BWD_CASES = {
    # B, Sq, Sk, Hq, Hkv, D, causal, window, positions, blk
    "mha_causal_d16": (2, 64, 64, 2, 2, 16, True, None, "arange", 32),
    "gqa4_window_d80": (1, 64, 64, 8, 2, 80, True, 24, "arange", 32),
    "gqa4_full_d16": (1, 64, 64, 8, 2, 16, False, None, "arange", 32),
    "dead_rows": (1, 64, 64, 4, 1, 16, True, None, "future", 32),
    "zigzag_gqa4": (1, 64, 64, 8, 2, 80, True, 40, "zigzag", 32),
    "sq_ne_sk": (1, 64, 128, 8, 2, 16, True, None, "offset", 32),
    "mha_causal_d128": (1, 64, 64, 4, 4, 128, True, None, "arange", 32),
    "mqa_g8_d256": (1, 64, 64, 8, 1, 256, True, None, "arange", 32),
}


def _block_positions(Sq, Sk, kind):
    """Shared (S,) positions of a block pair: "arange"; "future" (the first
    half of the query rows see no key at all under causal masking);
    "offset" (Sk > Sq keys straddle the queries); "zigzag" (two ranks' zigzag
    shards)."""
    if kind == "zigzag":
        return _zigzag(1, 2 * Sq, 2), _zigzag(0, 2 * Sk, 2)
    pos_q = np.arange(Sq, dtype=np.int32)
    pos_k = np.arange(Sk, dtype=np.int32) + {
        "arange": 0, "future": Sq // 2, "offset": (Sq - Sk) // 2}[kind]
    return pos_q, pos_k


def _bwd_inputs(B, Sq, Sk, Hq, Hkv, D, causal, window, kind, seed=0):
    """q, k, v, do, positions, and the *global* lse and delta =
    rowsum(do * o) of full attention over the block pair (from the plain
    forward), all numpy f32 / int32."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    do = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    pos_q, pos_k = _block_positions(Sq, Sk, kind)
    o, lse = flash_attention.flash_attention_fwd_plain(
        _t(q), _t(k), _t(v), _t(pos_q), _t(pos_k), causal=causal,
        window=window)
    delta = np.einsum("bshd,bshd->bhs", do, o.numpy())
    return (q, k, v, do, lse.numpy(), delta.astype(np.float32),
            pos_q.astype(np.int32), pos_k.astype(np.int32))


def _assert_grads(got, want, lse, tol=BWD_TOL):
    """dq, dk, dv within ``tol``; rows with a dead lse give dq = 0 exactly."""
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=tol,
                                   rtol=tol, err_msg=name)
    dead = np.swapaxes(np.asarray(lse) <= NEG_INF / 2, 1, 2)  # (B, Sq, Hq)
    assert (np.asarray(got[0])[dead] == 0.0).all()


RAGGED_BWD_CASES = {
    # B, Sq, Sk, Hq, Hkv, D, causal, window, zero_row: the cases of the JAX
    # tests/test_kernels.py::test_bwd_ragged_matches_ref, each row of the
    # batch at its own offset, plus a batch with a zero-length row
    "gqa": (2, 64, 64, 4, 2, 32, True, None, None),
    "mqa_rect": (2, 64, 128, 4, 1, 32, True, None, None),
    "window_non_pow2": (1, 96, 96, 2, 2, 32, True, 24, None),
    "full": (2, 64, 64, 2, 2, 32, False, None, None),
    # row 1's keys all sit past its queries: lse -1e30 on every head
    "zero_length_row": (3, 77, 77, 8, 2, 80, True, None, 1),
    "gqa4_d128": (2, 64, 64, 8, 2, 128, True, None, None),
    "mqa_g8_d256": (2, 64, 64, 8, 1, 256, True, None, None),
}


def _ragged_bwd_inputs(B, Sq, Sk, Hq, Hkv, D, causal, window, zero_row,
                       seed=0):
    """q, k, v, do, the global lse and delta of the block pair (from the
    plain forward) and per-row positions pos_q (B,Sq), pos_k (B,Sk): row b
    sits at offset 3b (the JAX test's layout); ``zero_row``'s keys are
    pushed past every query."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    do = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    off = 3 * np.arange(B, dtype=np.int32)[:, None]
    pos_q = off + np.arange(Sq, dtype=np.int32)[None]
    pos_k = off + (np.arange(Sk, dtype=np.int32) + (Sq - Sk) // 2)[None]
    if zero_row is not None:
        pos_k[zero_row] += 2 * (Sq + Sk)
    o, lse = ragged_prefill.ragged_prefill_fwd_plain(
        _t(q), _t(k), _t(v), _t(pos_q), _t(pos_k), causal=causal,
        window=window)
    delta = np.einsum("bshd,bshd->bhs", do, o.numpy())
    return (q, k, v, do, lse.numpy(), delta.astype(np.float32),
            np.ascontiguousarray(pos_q), np.ascontiguousarray(pos_k))


MMA_FWD_CASES = {
    # B, Sq, Sk, Hq, Hkv, D, causal, window, B1/B2 positions: shapes for the
    # tensor-core tiles of the bf16 forward (B1, B2, B5), every head size,
    # G = Hq / Hkv in {1, 4, 6, 8} (6 does not divide the 64 packed rows of
    # a tile), Sq and Sk not multiples of 64
    "d32_g4_dead_rows": (2, 150, 150, 4, 1, 32, True, None, "future"),
    "d64_g1_window_cuts_tiles": (2, 257, 257, 2, 2, 64, True, 40, "arange"),
    "d80_g4_zigzag_window": (1, 128, 128, 8, 2, 80, True, 100, "zigzag"),
    "d80_g6_sq77_sk203": (1, 77, 203, 12, 2, 80, True, None, "offset"),
    "d80_g4_bidirectional_window": (2, 193, 193, 4, 1, 80, False, 100,
                                    "arange"),
    "d128_g8_sq131": (1, 131, 131, 8, 1, 128, True, None, "arange"),
    # head size 256: the output's D over two CTAs, Q read from shared
    # memory per K tile (paligemma-3b's 8 query heads on one kv head)
    "d256_g8_sq131": (1, 131, 131, 8, 1, 256, True, None, "arange"),
}

# how each MMA_FWD_CASES case runs: B1 and B2 on the case's shared
# positions (B2 with a running accumulator that holds dead rows), B5 on
# per-row lengths with a zero-length row and at the decode shape (Sq = 1,
# so Sq * G <= 16: the kernel splits the keys over its warps)
FWD_ROUTES = ("B1", "B2", "B5_lengths", "B5_decode")


def _mma_fwd_inputs(route, B, Sq, Sk, Hq, Hkv, D, kind, seed=0):
    """(q, k, v, pos_q, pos_k, o_acc, lse_acc) numpy arrays of one
    MMA_FWD_CASES case run as ``route`` (the accumulator None but for B2)."""
    if route.startswith("B5"):
        lengths = route == "B5_lengths"
        q, k, v, pos_q, pos_k = _ragged_inputs(
            3 if lengths else 4, Sq if lengths else 1, Sk, Hq, Hkv, D,
            "lengths" if lengths else "decode", seed)
        return q, k, v, pos_q, pos_k, None, None
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    pos_q, pos_k = _block_positions(Sq, Sk, kind)
    o_acc = lse_acc = None
    if route == "B2":
        o_acc = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
        lse_acc = 3 * rng.normal(size=(B, Hq, Sq)).astype(np.float32)
        # the running accumulator has seen nothing yet on some rows
        o_acc[:, :5] = 0.0
        lse_acc[:, :, :5] = NEG_INF
    return (q, k, v, pos_q.astype(np.int32), pos_k.astype(np.int32), o_acc,
            lse_acc)


PREFIX_CASES = {
    # S, prefix_len, causal, window, D: keys below prefix_len are seen by
    # every query. With 64-key tiles, tiles 0 and 1 lie wholly inside the
    # prefix (every pair visible through the prefix alone) and one tile
    # straddles its end. D None: 32 on the CPU, 80 on the card
    "causal_p130": (200, 130, True, None, None),
    "window40_p100": (200, 100, True, 40, None),
    "bidirectional_window24_p70": (150, 70, False, 24, None),
    # paligemma-3b's head size, its prefix an eighth of the sequence
    "causal_p25_d256": (200, 25, True, None, 256),
}
PREFIX_ROUTES = ("B1", "B2", "B3", "B5", "B7")


def _prefix_inputs(route, S, prefix_len, causal, window, B=2, Hq=8, Hkv=2,
                   D=32, seed=0):
    """Inputs of one PREFIX_CASES case run as ``route``: q, k, v, pos_q,
    pos_k for the forward kernels (B2 adds an accumulator), and q, k, v,
    do, lse, delta, pos_q, pos_k for the backward (lse and delta from the
    plain forward under the same prefix-LM mask). B1, B2, B3 take shared
    (S,) positions; B5 and B7 per-row (B, S) positions, row b starting at
    37 b."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    if route in ("B5", "B7"):
        pos = np.ascontiguousarray(37 * np.arange(B, dtype=np.int32)[:, None]
                                   + pos[None])
    if route in ("B1", "B5"):
        return q, k, v, pos, pos
    if route == "B2":
        o_acc = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
        lse_acc = rng.normal(size=(B, Hq, S)).astype(np.float32)
        lse_acc[:, :, :7] = NEG_INF
        o_acc[:, :7] = 0.0
        return q, k, v, pos, pos, o_acc, lse_acc
    do = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    o, lse = ragged_prefill.ragged_prefill_fwd_plain(
        _t(q), _t(k), _t(v), _t(pos), _t(pos), causal=causal, window=window,
        prefix_len=prefix_len)
    delta = np.einsum("bshd,bshd->bhs", do, o.numpy()).astype(np.float32)
    return q, k, v, do, lse.numpy(), delta, pos, pos


PAGED_MMA_CASES = {
    # B4 on the tensor-core tile with split-KV: B, Hq, Hkv, D, page_size, W,
    # sp, rank, window, cache_len per row (0: an inactive slot, no pages)
    # the engine's shape: 4 slots, 32q/8kv heads of 80, pages of 16; an
    # inactive row beside live ones, a last page partly filled
    "engine_d80_inactive_row": (4, 32, 8, 80, 16, 64, 1, 0, 4096,
                                [1023, 520, 7, 0]),
    # one (row, kv head): 4 splits of 4 warps for 2 live tiles
    "more_splits_than_tiles": (1, 4, 1, 80, 16, 64, 1, 0, None, [100]),
    # window 8 at cache_len 1000: only the last page (992..1007) is live
    "window_last_page_only": (2, 8, 2, 80, 16, 64, 1, 0, 8, [1000, 1003]),
    # 24 does not divide 64: two pages per tile, its last 16 rows empty
    "page24": (3, 8, 2, 80, 24, 48, 1, 0, None, [1100, 30, 777]),
    "page64_sp2_rank1": (2, 8, 2, 64, 64, 16, 2, 1, 600, [1900, 131]),
    "page1_g16": (2, 16, 1, 32, 1, 300, 1, 0, None, [299, 64]),
    "d128": (4, 32, 8, 128, 16, 64, 1, 0, None, [1023, 64, 0, 500]),
    # GPT-3B's decode step: 12 kv heads of 256, MHA, two D slices per
    # (row, kv head)
    "d256_mha": (4, 12, 12, 256, 16, 64, 1, 0, None, [1023, 600, 7, 0]),
    "d256_g8_split": (1, 8, 1, 256, 16, 64, 1, 0, 100, [900]),
    # pages of 128 (two tiles each) and 96 (the second tile of a page half
    # empty), windows starting inside a page
    "page128_window300": (3, 8, 2, 80, 128, 12, 1, 0, 300, [1400, 130, 0]),
    "page96_sp2_rank1": (2, 8, 2, 128, 96, 10, 2, 1, 250, [1800, 77]),
    # 32 query heads a kv head: the unsplit route, two 16-row slabs
    "g32_d128": (2, 32, 1, 128, 16, 64, 1, 0, None, [1000, 0]),
    "g32_d256_page128": (2, 32, 1, 256, 128, 8, 1, 0, None, [900, 200]),
}

PAGED_MMA_PREFILL_CASES = {
    # B6 on the tensor-core tile: B, Sq, Hq, Hkv, D, page_size, W, sp, rank,
    # window, cached_len per row (0: nothing cached, every row dead)
    # the prefix phase's shape: a 256-query chunk after 1000 cached tokens
    # (a partly filled last page) beside a row with nothing cached
    "engine_d80": (2, 256, 32, 8, 80, 16, 96, 1, 0, 4096, [1000, 0]),
    # queries 200..295 in a window of 64: the later ones see no key
    "d128_window_slid": (1, 96, 8, 2, 128, 16, 24, 1, 0, 64, [200]),
    "g6_page4_sp2_rank1": (2, 50, 12, 2, 64, 4, 80, 2, 1, None, [300, 9]),
    "page64": (1, 70, 8, 2, 32, 64, 8, 1, 0, 250, [300]),
    # GPT-3B's chunk after a cached prefix: 12 heads of 256, two D slices
    "d256_mha": (2, 256, 12, 12, 256, 16, 96, 1, 0, None, [1000, 0]),
    "page128_window_slid": (1, 96, 8, 2, 80, 128, 12, 1, 0, 64, [700]),
    "page96_d256": (2, 50, 8, 2, 256, 96, 16, 1, 0, None, [900, 40]),
    "page48_sp2_rank1": (2, 40, 12, 2, 64, 48, 20, 2, 1, None, [600, 9]),
}


def _paged_pool_inputs(B, Sq, Hq, Hkv, D, ps, W, sp, rank, lens, decode,
                       seed=0):
    """q (B,Sq,Hq,D), pools, table (B,W) and lens: row b's table holds
    distinct pages for the blocks this rank owns among the positions
    written (decode: 0..cache_len, none for an inactive row at 0;
    prefill: the cached prefix and the suffix), -1 past them."""
    rng = np.random.default_rng(seed)
    owned = []
    for n in lens:
        written = (n + 1 if n else 0) if decode else n + Sq
        blocks = -(-written // ps)
        owned.append(min(W, max(0, (blocks - rank + sp - 1) // sp)))
    pages_loc = sum(owned) + 3
    pool_k = rng.normal(size=(pages_loc, ps, Hkv, D)).astype(np.float32)
    pool_v = rng.normal(size=(pages_loc, ps, Hkv, D)).astype(np.float32)
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    perm = rng.permutation(pages_loc).astype(np.int32)
    tbl = np.full((B, W), -1, np.int32)
    used = 0
    for b, n in enumerate(owned):
        tbl[b, :n] = perm[used:used + n]
        used += n
    return q, pool_k, pool_v, tbl, np.asarray(lens, np.int32)


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel vs its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("merge", [False, True], ids=["B1", "B2"])
@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_flash_fwd_kernel_matches_plain(cuda_device, case, merge, dtype):
    B, S, Hq, Hkv, D, causal, window, kind, _ = FWD_CASES[case]
    if D not in flash_attention.HEAD_DIMS:
        D = 32
    # a ragged edge: Sq, Sk not multiples of the 64-row tile
    S2 = S if kind == "zigzag" else S + 13
    q, k, v, pos_q, pos_k = _fwd_inputs(B, S2, Hq, Hkv, D, kind)
    dt = getattr(torch, dtype)
    args = [_t(x).to(cuda_device, dt) for x in (q, k, v)] + \
        [_t(x).to(cuda_device) for x in (pos_q, pos_k)]
    if merge:
        rng = np.random.default_rng(1)
        o_acc = _t(rng.normal(size=q.shape).astype(np.float32)).to(cuda_device)
        lse_acc = _t(rng.normal(size=(B, Hq, q.shape[1])).astype(
            np.float32)).to(cuda_device)
        lse_acc[:, :, :5] = NEG_INF
        o_acc[:, :5] = 0.0
        args += [o_acc, lse_acc]
    kw = dict(causal=causal, window=window)
    before = dict(flash_attention.LAUNCHES)
    o, lse = flash_attention.flash_attention_fwd(*args, **kw)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES["B2" if merge else "B1"] == \
        before["B2" if merge else "B1"] + 1
    o_p, lse_p = flash_attention.flash_attention_fwd_plain(*args, **kw)
    tol = 2e-5 if dtype == "float32" else 1e-4
    _assert_partials(o.cpu().numpy(), lse.cpu().numpy(),
                     o_p.cpu().numpy(), lse_p.cpu().numpy(), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_decode_kernel_matches_plain(cuda_device, case, dtype):
    B, Hq, Hkv, D, ps, W, sp, rank, window = PAGED_CASES[case]
    if D not in flash_attention.HEAD_DIMS:
        D = 32
    q, pool_k, pool_v, tbl, cl = _paged_inputs(B, Hq, Hkv, D, ps, W, sp)
    dt = getattr(torch, dtype)
    args = [_t(x).to(cuda_device, dt) for x in (q, pool_k, pool_v)] + \
        [_t(x).to(cuda_device) for x in (tbl, cl)] + [rank]
    kw = dict(sp=sp, page_size=ps, window=window)
    o, lse = paged_decode.paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    o_p, lse_p = paged_decode.paged_decode_attention_plain(*args, **kw)
    tol = 2e-5 if dtype == "float32" else 1e-4
    _assert_partials(o.cpu().numpy(), lse.cpu().numpy(),
                     o_p.cpu().numpy(), lse_p.cpu().numpy(), tol)


@pytest.mark.gpu
def test_kernel_wrappers_raise_on_unsupported_cuda_input(cuda_device):
    q = torch.zeros((1, 8, 2, 48), device=cuda_device)      # head_dim 48
    pos = torch.arange(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention.flash_attention_fwd(q, q, q, pos, pos)


@pytest.mark.gpu
def test_paged_kernels_raise_at_head_size_256(cuda_device):
    """B4 and B6 raise at head size 256 no more: on CUDA tensors, f32 and
    bf16, each launches its kernel (one count each) and matches its plain
    version (f32 2e-5, bf16 1e-4), the inactive slot exactly dead."""
    B, Hq, Hkv, _, ps, W, sp, rank, window = PAGED_CASES["gqa_d80"]
    q, pool_k, pool_v, tbl, cl = _paged_inputs(B, Hq, Hkv, 256, ps, W, sp)
    kw = dict(sp=sp, page_size=ps)
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 1e-4)):
        args = [_t(x).to(cuda_device, dtype) for x in (q, pool_k, pool_v)] \
            + [_t(x).to(cuda_device) for x in (tbl, cl)] + [rank]
        for mod, name, fn, plain in (
                (paged_decode, "B4", paged_decode.paged_decode_attention,
                 paged_decode.paged_decode_attention_plain),
                (paged_prefill, "B6", paged_prefill.paged_prefill_attention,
                 paged_prefill.paged_prefill_attention_plain)):
            before = mod.LAUNCHES[name]
            o, lse = fn(*args, **kw)
            torch.cuda.synchronize()
            assert mod.LAUNCHES[name] == before + 1
            o_p, lse_p = plain(*args, **kw)
            _assert_partials(o.cpu().numpy(), lse.cpu().numpy(),
                             o_p.cpu().numpy(), lse_p.cpu().numpy(), tol)
            assert (lse[-1] == NEG_INF).all() and (o[-1] == 0).all()

@pytest.mark.gpu
@pytest.mark.parametrize("attention_impl", ["startrail", "local", "ulysses"])
def test_attention_route_launches_its_kernel(cuda_device, attention_impl):
    """At P = 1 the StarTrail route is one ring step through B2, and the
    local and Ulysses routes one block through B1; all match full plain
    attention."""
    from repro_torch.dist.comm import SingleComm
    from repro_torch.kernels import ref
    from repro_torch.models.runtime import Runtime

    S, window = 77, 24
    q, k, v, _, _ = _fwd_inputs(1, S, 8, 2, 80, "arange")
    q, k, v = (_t(x).to(cuda_device) for x in (q, k, v))
    rt = Runtime(comm=SingleComm(), st_cfg=st_torch.StarTrailConfig(
        seq_len=S, seq_scheme="contiguous", window=window,
        block_impl="cuda"), attention_impl=attention_impl,
        device=cuda_device)
    flash_attention.reset_launches()
    o = rt.attention(q, k, v, window=window)
    torch.cuda.synchronize()
    local = attention_impl != "startrail"
    assert flash_attention.LAUNCHES == {"B1": int(local), "B2": int(not local),
                                        "B3": 0}
    want = ref.mha_reference(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(o.cpu().numpy(), want.cpu().numpy(),
                               atol=TOL, rtol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_bwd_kernel_matches_plain(cuda_device, case, dtype):
    B, Sq, Sk, Hq, Hkv, D, causal, window, kind, _ = BWD_CASES[case]
    if D not in flash_attention.HEAD_DIMS:
        D = 32
    if kind != "zigzag":
        # a ragged edge: Sq, Sk not multiples of the 64-row tile
        Sq, Sk = Sq + 13, Sk + 13
    arrs = _bwd_inputs(B, Sq, Sk, Hq, Hkv, D, causal, window, kind)
    dt = getattr(torch, dtype)
    args = [_t(x).to(cuda_device, dt) for x in arrs[:4]] + \
        [_t(x).to(cuda_device) for x in arrs[4:]]
    kw = dict(causal=causal, window=window)
    before = flash_attention.LAUNCHES["B3"]
    got = flash_attention.flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES["B3"] == before + 1
    want = flash_attention.flash_attention_bwd_plain(*args, **kw)
    _assert_grads([g.cpu().numpy() for g in got],
                  [w.cpu().numpy() for w in want], arrs[4])
    again = flash_attention.flash_attention_bwd(*args, **kw)
    for a, b in zip(got, again):           # no atomics: the same bits
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_startrail_backward_launches_b3(cuda_device):
    """At P = 1 the autograd backward of ``StarTrailAttention`` is one ring
    step through B3 per call, and equals the explicit functions."""
    from repro_torch.dist.comm import SingleComm

    S, window = 77, 24
    q, k, v, _, _ = _fwd_inputs(1, S, 8, 2, 80, "arange")
    do = torch.randn((1, S, 8, 80), device=cuda_device)
    q, k, v = (_t(x).to(cuda_device).requires_grad_() for x in (q, k, v))
    cfg = st_torch.StarTrailConfig(seq_len=S, seq_scheme="contiguous",
                                   window=window, block_impl="cuda")
    flash_attention.reset_launches()
    o = st_torch.startrail_attention(q, k, v, cfg, SingleComm())
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == {"B1": 0, "B2": 1, "B3": 1}
    with torch.no_grad():
        o2, res = st_torch.startrail_forward(q, k, v, cfg, SingleComm())
        want = st_torch.startrail_backward(res, o2, do, cfg, SingleComm())
    for a, b in zip((dq, dk, dv), want):
        assert torch.equal(a, b)



@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(RAGGED_CASES))
def test_ragged_prefill_kernel_matches_plain(cuda_device, case, dtype):
    B, Sq, Sk, Hq, Hkv, D, window, kind = RAGGED_CASES[case]
    if D not in flash_attention.HEAD_DIMS:
        D = 32
    arrs = _ragged_inputs(B, Sq, Sk, Hq, Hkv, D, kind)
    dt = getattr(torch, dtype)
    args = [_t(x).to(cuda_device, dt) for x in arrs[:3]] + \
        [_t(x).to(cuda_device) for x in arrs[3:]]
    before = ragged_prefill.LAUNCHES["B5"]
    o, lse = ragged_prefill.ragged_prefill_fwd(*args, window=window)
    torch.cuda.synchronize()
    assert ragged_prefill.LAUNCHES["B5"] == before + 1
    o_p, lse_p = ragged_prefill.ragged_prefill_fwd_plain(*args,
                                                         window=window)
    tol = 2e-5 if dtype == "float32" else 1e-4
    _assert_partials(o.cpu().numpy(), lse.cpu().numpy(),
                     o_p.cpu().numpy(), lse_p.cpu().numpy(), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(PAGED_PREFILL_CASES))
def test_paged_prefill_kernel_matches_plain(cuda_device, case, dtype):
    B, Sq, Hq, Hkv, D, ps, W, sp, rank, window, cls = \
        PAGED_PREFILL_CASES[case]
    if D not in flash_attention.HEAD_DIMS:
        D = 32
    arrs = _paged_prefill_inputs(B, Sq, Hq, Hkv, D, ps, W, sp, rank, cls)
    dt = getattr(torch, dtype)
    args = [_t(x).to(cuda_device, dt) for x in arrs[:3]] + \
        [_t(x).to(cuda_device) for x in arrs[3:]] + [rank]
    kw = dict(sp=sp, page_size=ps, window=window)
    before = paged_prefill.LAUNCHES["B6"]
    o, lse = paged_prefill.paged_prefill_attention(*args, **kw)
    torch.cuda.synchronize()
    assert paged_prefill.LAUNCHES["B6"] == before + 1
    o_p, lse_p = paged_prefill.paged_prefill_attention_plain(*args, **kw)
    tol = 2e-5 if dtype == "float32" else 1e-4
    _assert_partials(o.cpu().numpy(), lse.cpu().numpy(),
                     o_p.cpu().numpy(), lse_p.cpu().numpy(), tol)


@pytest.mark.gpu
def test_batched_positions_route_to_b5(cuda_device):
    """``dispatch.block_fwd`` and ``block_fwd_merge`` with (B, S) positions
    launch B5 on CUDA tensors, and ``block_bwd`` launches B7."""
    from repro_torch.kernels import dispatch

    arrs = _ragged_inputs(*RAGGED_CASES["ragged_rows"][:6], "lengths")
    q, k, v, pq, pk = (_t(x).to(cuda_device) for x in arrs)
    ragged_prefill.reset_launches()
    o, lse = dispatch.block_fwd(q, k, v, pq, pk, impl="cuda")
    o_acc = torch.zeros_like(o)
    lse_acc = torch.full_like(lse, NEG_INF)
    o2, lse2 = dispatch.block_fwd_merge(q, k, v, o_acc, lse_acc, pq, pk,
                                        impl="cuda")
    torch.cuda.synchronize()
    assert ragged_prefill.LAUNCHES == {"B5": 2}
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    do = torch.randn_like(q)
    delta = torch.einsum("bshd,bshd->bhs", do, o).contiguous()
    ragged_bwd.reset_launches()
    flash_attention.reset_launches()
    got = dispatch.block_bwd(q, k, v, do, lse, delta, pq, pk, impl="cuda")
    torch.cuda.synchronize()
    assert ragged_bwd.LAUNCHES == {"B7": 1}
    assert flash_attention.LAUNCHES["B3"] == 0
    want = ragged_bwd.flash_attention_bwd_ragged_plain(q, k, v, do, lse,
                                                       delta, pq, pk)
    _assert_grads([g.cpu().numpy() for g in got],
                  [w.cpu().numpy() for w in want], lse.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(RAGGED_BWD_CASES))
def test_ragged_bwd_kernel_matches_plain(cuda_device, case, dtype):
    arrs = _ragged_bwd_inputs(*RAGGED_BWD_CASES[case])
    causal, window, zero_row = RAGGED_BWD_CASES[case][6:]
    dt = getattr(torch, dtype)
    args = [_t(x).to(cuda_device, dt) for x in arrs[:4]] + \
        [_t(x).to(cuda_device) for x in arrs[4:]]
    kw = dict(causal=causal, window=window)
    before = ragged_bwd.LAUNCHES["B7"]
    got = ragged_bwd.flash_attention_bwd_ragged(*args, **kw)
    torch.cuda.synchronize()
    assert ragged_bwd.LAUNCHES["B7"] == before + 1
    want = ragged_bwd.flash_attention_bwd_ragged_plain(*args, **kw)
    _assert_grads([g.cpu().numpy() for g in got],
                  [w.cpu().numpy() for w in want], arrs[4])
    if zero_row is not None:
        # the zero-length row: dq = 0 and nothing into dk, dv, exactly
        assert all(bool((g[zero_row] == 0).all()) for g in got)
    again = ragged_bwd.flash_attention_bwd_ragged(*args, **kw)
    for a, b in zip(got, again):           # no atomics: the same bits
        assert torch.equal(a, b)


MMA_BWD_CASES = {
    # B, Sq, Sk, Hq, Hkv, D, causal, window, B3 positions: bf16 shapes for
    # the tensor-core tiles of B3 and B7, one per head size, each with two
    # batch rows (B7 pushes row 1's keys past its queries)
    "d32_dead_rows": (2, 150, 150, 4, 2, 32, True, None, "future"),
    "d64_window_cuts_tiles": (2, 257, 257, 8, 2, 64, True, 40, "arange"),
    "d80_causal_s1024": (2, 1024, 1024, 8, 2, 80, True, None, "arange"),
    "d80_bidirectional_window": (2, 193, 193, 4, 2, 80, False, 100,
                                 "arange"),
    "d128_sq131_sk203": (2, 131, 203, 4, 1, 128, True, None, "offset"),
    # head size 256: dq over two CTAs, dk/dv over four
    "d256_g8_sq131_sk203": (2, 131, 203, 8, 1, 256, True, None, "offset"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["B3", "B7"])
@pytest.mark.parametrize("case", sorted(MMA_BWD_CASES))
def test_bwd_tensor_core_tiles_match_plain(cuda_device, case, route):
    """The bf16 backward (mma.sync tiles, P and dS as hi/lo pairs) against
    its plain version at BWD_TOL, at every head size, over many 64-row
    tiles, a window edge inside a tile and ragged Sq / Sk; dead rows (B3)
    and the zero-length row (B7) exactly 0; two runs give the same bits."""
    B, Sq, Sk, Hq, Hkv, D, causal, window, kind = MMA_BWD_CASES[case]
    if route == "B3":
        arrs = _bwd_inputs(B, Sq, Sk, Hq, Hkv, D, causal, window, kind)
        fn = flash_attention.flash_attention_bwd
        plain = flash_attention.flash_attention_bwd_plain
        launches = flash_attention.LAUNCHES
    else:
        arrs = _ragged_bwd_inputs(B, Sq, Sk, Hq, Hkv, D, causal, window, 1)
        fn = ragged_bwd.flash_attention_bwd_ragged
        plain = ragged_bwd.flash_attention_bwd_ragged_plain
        launches = ragged_bwd.LAUNCHES
    args = [_t(x).to(cuda_device, torch.bfloat16) for x in arrs[:4]] + \
        [_t(x).to(cuda_device) for x in arrs[4:]]
    kw = dict(causal=causal, window=window)
    before = launches[route]
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert launches[route] == before + 1
    want = plain(*args, **kw)
    _assert_grads([g.cpu().numpy() for g in got],
                  [w.cpu().numpy() for w in want], arrs[4])
    if route == "B7":
        assert all(bool((g[1] == 0).all()) for g in got)
    elif kind == "future":
        assert (arrs[4] <= NEG_INF / 2).any()      # there are dead rows
    again = fn(*args, **kw)
    for a, b in zip(got, again):           # no atomics: the same bits
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_bwd_long_block_stays_within_tolerance(cuda_device):
    """B3 on one 12288-token bf16 block, 4 query heads over one kv head,
    causal: dk sums 4 x 12288 query rows and dq 12288 keys. The tensor
    cores' f32 accumulation truncates, so the kernels sum each tile's share
    in a fresh accumulator before one f32 add; a single MMA chain over the
    block drifts past BWD_TOL at this length."""
    S, Hq = 12288, 4
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, do = (torch.randn((1, S, Hq, 80), generator=g, device=cuda_device)
             .bfloat16() for _ in range(2))
    k, v = (torch.randn((1, S, 1, 80), generator=g, device=cuda_device)
            .bfloat16() for _ in range(2))
    pos = torch.arange(S, dtype=torch.int32, device=cuda_device)
    o, lse = flash_attention.flash_attention_fwd_plain(q, k, v, pos, pos)
    delta = torch.einsum("bshd,bshd->bhs", do.float(),
                         o.bfloat16().float()).contiguous()
    args = (q, k, v, do, lse, delta, pos, pos)
    got = flash_attention.flash_attention_bwd(*args)
    torch.cuda.synchronize()
    want = flash_attention.flash_attention_bwd_plain(*args)
    _assert_grads([t.cpu().numpy() for t in got],
                  [t.cpu().numpy() for t in want], lse.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("remat", ["none", "attn_out", "full"])
def test_recompute_reruns_the_attention_forward(cuda_device, remat):
    """A training step of a 2-layer model launches B3 once per layer and B2
    once per layer without recompute, twice with it ('attn_out', 'full');
    the loss and gradients are those of remat='none' within f32 rounding
    (the recomputed forward runs the same kernels on the same inputs)."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.models.factory import build_model
    from repro_torch.train import step as train_step

    # the smoke model with a head width the kernels take
    cfg = dataclasses.replace(registry.get_smoke("h2o-danube-1.8b"),
                              head_dim=32)
    model = build_model(cfg, device=cuda_device, seed=0)
    shape = ShapeConfig("t", 64, 2, "train")
    rng = np.random.default_rng(0)
    batch = {n: _t(rng.integers(0, cfg.vocab_size, (2, 64),
                                dtype=np.int32)).to(cuda_device)
             for n in ("tokens", "labels")}
    out = {}
    for r in dict.fromkeys(("none", remat)):
        vg_fn, _ = train_step.build_value_and_grad_fn(
            model, RunConfig(remat=r), shape)
        flash_attention.reset_launches()
        out[r] = vg_fn(batch)
        torch.cuda.synchronize()
        L = cfg.num_layers
        assert flash_attention.LAUNCHES == {
            "B1": 0, "B2": L * (1 if r == "none" else 2), "B3": L}
    (loss0, g0), (loss1, g1) = out["none"], out[remat]
    torch.testing.assert_close(loss1, loss0, rtol=1e-6, atol=0)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("rules", ["default", "fsdp", "tp"])
def test_mesh_step_under_rules_matches_cpu(cuda_device, rules):
    """One train step of the smoke model (head width 32, which the kernels
    take) on ``ThreadMesh(c=2, r=1, data=2)`` threads under each sharding
    rule set, on the card and on the CPU from the same weights and batch:
    loss, gradient norm and every updated parameter within 2e-3."""
    import copy

    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.factory import build_model
    from repro_torch.optim import adamw
    from repro_torch.plan import make_plan

    cfg = dataclasses.replace(registry.get_smoke("h2o-danube-1.8b"),
                              head_dim=32)
    cpu = build_model(cfg, device="cpu", seed=0)
    plan = make_plan(cfg, ShapeConfig("t", 64, 2, "train"), n_devices=8,
                     data=2, c=2, sharding_rules=rules)
    batch = SyntheticLM(cfg, plan.shape_config(), seed=0,
                        sp_size=plan.sp_size).get_batch(0)
    adam = adamw.AdamWConfig(learning_rate=1e-3, warmup_steps=0)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = copy.deepcopy(cpu).to(dev)
        step, sh = plan.build_train_step(model, adam)
        _, m = step(adamw.init_state(sh["params"], adam),
                    {k: _t(v).to(dev) for k, v in batch.items()})
        out[dev.type] = (m, [p.detach().cpu() for p in sh["params"]])
    (m_gpu, p_gpu), (m_cpu, p_cpu) = out["cuda"], out["cpu"]
    for key in ("loss", "grad_norm"):
        assert abs(float(m_gpu[key]) - float(m_cpu[key])) < 2e-3, key
    assert max(float((a - b).abs().max()) for a, b in zip(p_gpu, p_cpu)) \
        < 2e-3


@pytest.mark.gpu
@pytest.mark.parametrize("route", FWD_ROUTES)
@pytest.mark.parametrize("case", sorted(MMA_FWD_CASES))
def test_fwd_tensor_core_tiles_match_plain(cuda_device, case, route):
    """The bf16 forward (flash_fwd_mma: packed (query, head) rows, mma.sync
    tiles, P as a hi/lo pair; keys split over the warps at the decode
    shape) against its plain version within 1e-4, at every head size and G
    in {1, 4, 6, 8}, over many 64-row tiles, a window edge inside a tile and
    ragged Sq / Sk, as B1, B2 and B5; dead rows and the zero-length row
    exact; two runs give the same bits."""
    B, Sq, Sk, Hq, Hkv, D, causal, window, kind = MMA_FWD_CASES[case]
    arrs = _mma_fwd_inputs(route, B, Sq, Sk, Hq, Hkv, D, kind)
    args = [_t(x).to(cuda_device, torch.bfloat16) for x in arrs[:3]] + \
        [_t(x).to(cuda_device) for x in arrs[3:] if x is not None]
    kw = dict(causal=causal, window=window)
    if route.startswith("B5"):
        fn, plain = ragged_prefill.ragged_prefill_fwd, \
            ragged_prefill.ragged_prefill_fwd_plain
        launches, name = ragged_prefill.LAUNCHES, "B5"
    else:
        fn, plain = flash_attention.flash_attention_fwd, \
            flash_attention.flash_attention_fwd_plain
        launches, name = flash_attention.LAUNCHES, route
    before = launches[name]
    o, lse = fn(*args, **kw)
    torch.cuda.synchronize()
    assert launches[name] == before + 1
    o_p, lse_p = plain(*args, **kw)
    _assert_partials(o.cpu().numpy(), lse.cpu().numpy(), o_p.cpu().numpy(),
                     lse_p.cpu().numpy(), 1e-4)
    if route == "B5_lengths":            # the zero-length row
        assert (lse[2] == NEG_INF).all() and (o[2] == 0).all()
    elif kind == "future" and route == "B1":
        assert (lse_p <= NEG_INF / 2).any()        # there are dead rows
    o2, lse2 = fn(*args, **kw)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)   # no atomics


@pytest.mark.gpu
def test_fwd_long_block_stays_within_tolerance(cuda_device):
    """B2 on one 12288-token bf16 block, 4 query heads over one kv head,
    causal: a row sums up to 12288 keys. The tensor cores' f32
    accumulation truncates, so each tile's P V goes into a fresh
    accumulator and is added with one f32 multiply-add; a single MMA chain
    over the block would drift."""
    S, Hq = 12288, 4
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q = torch.randn((1, S, Hq, 80), generator=g, device=cuda_device)
    k, v = (torch.randn((1, S, 1, 80), generator=g, device=cuda_device)
            for _ in range(2))
    o_acc = torch.randn((1, S, Hq, 80), generator=g, device=cuda_device)
    lse_acc = 3 * torch.randn((1, Hq, S), generator=g, device=cuda_device)
    pos = torch.arange(S, dtype=torch.int32, device=cuda_device)
    args = [t.bfloat16() for t in (q, k, v)] + [pos, pos, o_acc, lse_acc]
    o, lse = flash_attention.flash_attention_fwd(*args)
    torch.cuda.synchronize()
    o_p, lse_p = flash_attention.flash_attention_fwd_plain(*args)
    _assert_partials(o.cpu().numpy(), lse.cpu().numpy(), o_p.cpu().numpy(),
                     lse_p.cpu().numpy(), 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", PREFIX_ROUTES)
@pytest.mark.parametrize("case", sorted(PREFIX_CASES))
def test_prefix_lm_kernel_matches_plain(cuda_device, case, route, dtype):
    """The prefix-LM mask (prefix_len) on the card: every kernel that takes
    it against its plain version, causal and windowed, with 64-key tiles
    wholly inside the prefix (whose pairs are all visible through it, so
    the tile skips the per-element mask) and one straddling its end."""
    S, prefix_len, causal, window, D = PREFIX_CASES[case]
    arrs = _prefix_inputs(route, S, prefix_len, causal, window, D=D or 80)
    n_in = 4 if route in ("B3", "B7") else 3
    dt = getattr(torch, dtype)
    args = [_t(x).to(cuda_device, dt) for x in arrs[:n_in]] + \
        [_t(x).to(cuda_device) for x in arrs[n_in:]]
    kw = dict(causal=causal, window=window, prefix_len=prefix_len)
    fn, plain, launches = {
        "B1": (flash_attention.flash_attention_fwd,
               flash_attention.flash_attention_fwd_plain,
               flash_attention.LAUNCHES),
        "B2": (flash_attention.flash_attention_fwd,
               flash_attention.flash_attention_fwd_plain,
               flash_attention.LAUNCHES),
        "B3": (flash_attention.flash_attention_bwd,
               flash_attention.flash_attention_bwd_plain,
               flash_attention.LAUNCHES),
        "B5": (ragged_prefill.ragged_prefill_fwd,
               ragged_prefill.ragged_prefill_fwd_plain,
               ragged_prefill.LAUNCHES),
        "B7": (ragged_bwd.flash_attention_bwd_ragged,
               ragged_bwd.flash_attention_bwd_ragged_plain,
               ragged_bwd.LAUNCHES),
    }[route]
    before = launches[route]
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert launches[route] == before + 1
    want = plain(*args, **kw)
    if route in ("B3", "B7"):
        _assert_grads([g.cpu().numpy() for g in got],
                      [w.cpu().numpy() for w in want], arrs[4])
    else:
        tol = 2e-5 if dtype == "float32" else 1e-4
        _assert_partials(*(t.cpu().numpy() for t in (*got, *want)), tol)


def _run_twice(fn, args, kw, launches, name):
    """fn(*args, **kw) twice: each call adds exactly one launch, and the
    two give the same bits (no atomics touch values)."""
    before = launches[name]
    o, lse = fn(*args, **kw)
    torch.cuda.synchronize()
    assert launches[name] == before + 1
    o2, lse2 = fn(*args, **kw)
    torch.cuda.synchronize()
    assert launches[name] == before + 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    return o, lse


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(PAGED_MMA_CASES))
def test_paged_decode_split_kv_matches_plain(cuda_device, case, dtype):
    """B4 against its plain version: bf16 runs the tensor-core tile over
    the paged source with the keys split over CTAs (split-KV) and warps,
    f32 the CUDA-core kernel; inactive rows and dead rows exact."""
    B, Hq, Hkv, D, ps, W, sp, rank, window, lens = PAGED_MMA_CASES[case]
    arrs = _paged_pool_inputs(B, 1, Hq, Hkv, D, ps, W, sp, rank, lens, True)
    dt = getattr(torch, dtype)
    args = [_t(x).to(cuda_device, dt) for x in arrs[:3]] + \
        [_t(x).to(cuda_device) for x in arrs[3:]] + [rank]
    kw = dict(sp=sp, page_size=ps, window=window)
    if case == "more_splits_than_tiles" and dtype == "bfloat16":
        sms = torch.cuda.get_device_properties(
            cuda_device).multi_processor_count
        splits = paged_decode.decode_splits(B, Hkv, D, W, ps, sms)
        assert splits * 4 > -(-(lens[0] + 1) // 64)     # walkers > tiles
    o, lse = _run_twice(paged_decode.paged_decode_attention, args, kw,
                        paged_decode.LAUNCHES, "B4")
    o_p, lse_p = paged_decode.paged_decode_attention_plain(*args, **kw)
    tol = 2e-5 if dtype == "float32" else 1e-4
    _assert_partials(o.cpu().numpy(), lse.cpu().numpy(),
                     o_p.cpu().numpy(), lse_p.cpu().numpy(), tol)
    for b, n in enumerate(lens):
        if n == 0:                                  # the inactive slot
            assert (lse[b] == NEG_INF).all() and (o[b] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(PAGED_MMA_PREFILL_CASES))
def test_paged_prefill_tensor_core_matches_plain(cuda_device, case, dtype):
    """B6 against its plain version: bf16 runs the tensor-core tile over
    the paged source (64 packed rows of a kv group per CTA), f32 the
    CUDA-core kernel; rows with nothing cached or whose window slid past
    the prefix are dead and exact."""
    B, Sq, Hq, Hkv, D, ps, W, sp, rank, window, lens = \
        PAGED_MMA_PREFILL_CASES[case]
    arrs = _paged_pool_inputs(B, Sq, Hq, Hkv, D, ps, W, sp, rank, lens,
                              False)
    dt = getattr(torch, dtype)
    args = [_t(x).to(cuda_device, dt) for x in arrs[:3]] + \
        [_t(x).to(cuda_device) for x in arrs[3:]] + [rank]
    kw = dict(sp=sp, page_size=ps, window=window)
    o, lse = _run_twice(paged_prefill.paged_prefill_attention, args, kw,
                        paged_prefill.LAUNCHES, "B6")
    o_p, lse_p = paged_prefill.paged_prefill_attention_plain(*args, **kw)
    tol = 2e-5 if dtype == "float32" else 1e-4
    _assert_partials(o.cpu().numpy(), lse.cpu().numpy(),
                     o_p.cpu().numpy(), lse_p.cpu().numpy(), tol)
    if 0 in lens:
        assert (lse[lens.index(0)] == NEG_INF).all()
    if window is not None and window < Sq:
        dead = (lse_p <= NEG_INF / 2)
        assert dead.any() and not dead.all()


# Key ranges longer than one chunk of the paged forward (at most 4096 key
# tiles reading at most 2048 table entries, csrc/flash_fwd.cuh), which it
# reads, flags and walks chunk by chunk, and B1 over as many keys in one
# block (its flags all in shared memory): case -> (head size, query rows,
# query heads, kv heads)
CHUNKED_KEYS = 270_000
CHUNKED_CASES = {
    "B1_split_keys": (80, 4, 4, 1),        # Sq * G = 16: the warps split
    "B1": (80, 64, 4, 1),
    "B4_d256_page16": (256, 1, 8, 1),      # 16,875 table entries
    "B4_d256_page128_g32": (256, 1, 32, 1),
    "B6_d256_page16": (256, 16, 8, 1),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CHUNKED_CASES))
def test_keys_past_flag_cap_match_plain(cuda_device, case):
    """B1, B4 and B6 in bf16 over 270,000 keys (4,219 key tiles; B4 and B6
    walk their tables of 16,875 entries at pages of 16 in 9 chunks of 512
    tiles, of 2,110 at pages of 128 in 2 chunks) against their plain
    versions within 1e-4, causal, the queries at the end: one launch each,
    the same bits twice."""
    D, Sq, Hq, Hkv = CHUNKED_CASES[case]
    n = CHUNKED_KEYS
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q = torch.randn((1, Sq, Hq, D), generator=g,
                    device=cuda_device).bfloat16()
    if case.startswith("B1"):
        k, v = (torch.randn((1, n, Hkv, D), generator=g,
                            device=cuda_device).bfloat16() for _ in range(2))
        pos_k = torch.arange(n, dtype=torch.int32, device=cuda_device)
        args, kw = (q, k, v, pos_k[n - Sq:], pos_k), dict(causal=True)
        fn, plain = flash_attention.flash_attention_fwd, \
            flash_attention.flash_attention_fwd_plain
        launches, name = flash_attention.LAUNCHES, "B1"
    else:
        ps = 128 if "page128" in case else 16
        W = -(-n // ps)
        pool_k, pool_v = (torch.randn((W + 3, ps, Hkv, D), generator=g,
                                      device=cuda_device).bfloat16()
                          for _ in range(2))
        table = torch.randperm(W + 3, generator=g, device=cuda_device)[:W]
        table = table.to(torch.int32)[None].contiguous()
        kw = dict(sp=1, page_size=ps)
        if case.startswith("B4"):
            lens = torch.tensor([n - 1], dtype=torch.int32,
                                device=cuda_device)
            fn, plain = paged_decode.paged_decode_attention, \
                paged_decode.paged_decode_attention_plain
            launches, name = paged_decode.LAUNCHES, "B4"
        else:
            lens = torch.tensor([n - Sq], dtype=torch.int32,
                                device=cuda_device)
            fn, plain = paged_prefill.paged_prefill_attention, \
                paged_prefill.paged_prefill_attention_plain
            launches, name = paged_prefill.LAUNCHES, "B6"
        args = (q, pool_k, pool_v, table, lens, 0)
    o, lse = _run_twice(fn, args, kw, launches, name)
    o_p, lse_p = plain(*args, **kw)
    _assert_partials(o.cpu().numpy(), lse.cpu().numpy(), o_p.cpu().numpy(),
                     lse_p.cpu().numpy(), 1e-4)


# Ulysses at full width, P = 8: each rank attends 4 query heads over one kv
# head of 80 across the whole 4096-token sequence, its positions in the
# all-to-all's order (the zigzag shards concatenated: unsorted), beside the
# same shape with sorted positions
ULYSSES_POSITIONS = ("zigzag_concat", "sorted")


def ulysses_positions(kind, n=4096, p=8):
    if kind == "sorted":
        return np.arange(n, dtype=np.int32)
    return np.concatenate([_zigzag(r, n, p) for r in range(p)]).astype(
        np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ULYSSES_POSITIONS)
def test_b1_b3_at_the_ulysses_shape(cuda_device, kind, dtype):
    S, window = 4096, 4096
    rng = np.random.default_rng(5)
    dt = getattr(torch, dtype)
    q, k, v, do = (_t(rng.normal(size=(1, S, h, 80)).astype(
        np.float32)).to(cuda_device, dt) for h in (4, 1, 1, 4))
    pos = _t(ulysses_positions(kind, S)).to(cuda_device)
    o, lse = flash_attention.flash_attention_fwd(q, k, v, pos, pos,
                                                 window=window)
    torch.cuda.synchronize()
    o_p, lse_p = flash_attention.flash_attention_fwd_plain(
        q, k, v, pos, pos, window=window)
    tol = 2e-5 if dtype == "float32" else 1e-4
    _assert_partials(o.cpu().numpy(), lse.cpu().numpy(),
                     o_p.cpu().numpy(), lse_p.cpu().numpy(), tol)
    delta = torch.einsum("bshd,bshd->bhs", do.float(),
                         o_p.to(dt).float()).contiguous()
    args = (q, k, v, do, lse_p, delta, pos, pos)
    got = flash_attention.flash_attention_bwd(*args, window=window)
    torch.cuda.synchronize()
    want = flash_attention.flash_attention_bwd_plain(*args, window=window)
    _assert_grads([g.cpu().numpy() for g in got],
                  [w.cpu().numpy() for w in want], lse_p.cpu().numpy())


@pytest.mark.gpu
def test_flash_attention_function_launches_b1_and_b3(cuda_device):
    """``kernels.ops.flash_attention`` (Ulysses' attention) runs B1 forward
    and B3 backward, and matches its plain version's gradients."""
    from repro_torch.kernels import ops

    S, window = 77, 24
    q, k, v, _, _ = _fwd_inputs(1, S, 8, 2, 80, "arange")
    pos = torch.from_numpy(ulysses_positions("zigzag_concat", 80, 4)[
        :S].copy()).to(cuda_device)
    do = torch.randn((1, S, 8, 80), device=cuda_device)
    out = {}
    for impl in ("cuda", "ref"):
        x = [_t(a).to(cuda_device).requires_grad_() for a in (q, k, v)]
        flash_attention.reset_launches()
        o = ops.flash_attention(*x, pos, pos, window=window, impl=impl)
        grads = torch.autograd.grad(o, x, do)
        torch.cuda.synchronize()
        out[impl] = (dict(flash_attention.LAUNCHES), o, grads)
    assert out["cuda"][0] == {"B1": 1, "B2": 0, "B3": 1}
    assert out["ref"][0] == {"B1": 0, "B2": 0, "B3": 0}
    np.testing.assert_allclose(out["cuda"][1].detach().cpu().numpy(),
                               out["ref"][1].detach().cpu().numpy(),
                               atol=TOL, rtol=TOL)
    for a, b in zip(out["cuda"][2], out["ref"][2]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   atol=BWD_TOL, rtol=BWD_TOL)


@pytest.mark.gpu
def test_engine_step_at_p2_on_the_card(cuda_device):
    """The engine at SP degree 2 (``ThreadMesh(c=1, r=2)`` threads on the
    card), smoke minitron-8b with heads of 32 in f32: one step admits both
    requests (B2 on both ranks, 2 ring steps, every layer, for each prompt)
    and decodes once (B4 on both ranks and every layer); both ranks sample
    the same tokens, and the streams equal the P = 1 engine's."""
    from repro_torch.configs import registry
    from repro_torch.engine import Engine, EngineConfig, Request
    from repro_torch.models.factory import build_model
    from repro_torch.plan import make_serve_plan

    cfg = dataclasses.replace(registry.get_smoke("minitron-8b"), head_dim=32)
    model = build_model(cfg, device=cuda_device, seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (13, 6)]
    out = {}
    for sp in (1, 2):
        engine = Engine(model, make_serve_plan(
            cfg, arch="minitron-8b", n_devices=sp, c=1, decode_batch=2,
            page_size=4, max_len=64), EngineConfig(pages_per_shard=32))
        for i, p in enumerate(prompts):
            engine.add_request(Request(f"r{i}", p, 5))
        flash_attention.reset_launches()
        paged_decode.reset_launches()
        engine.step()
        torch.cuda.synchronize()
        L = cfg.num_layers
        assert flash_attention.LAUNCHES == {"B1": 0, "B2": sp * sp * L * 2,
                                            "B3": 0}
        assert paged_decode.LAUNCHES == {"B4": sp * L}
        out[sp] = engine.run()
    assert out[2] == out[1] and [len(v) for v in out[1].values()] == [5, 5]


@pytest.mark.gpu
def test_paged_launch_counts_survive_rank_threads(cuda_device):
    """16 threads launch B4 and B6 at a 1 us switch interval (the ranks of
    a ThreadMesh engine do so from their own threads): no count is lost."""
    import sys
    import threading

    q, pool_k, pool_v, tbl, cl = _paged_inputs(3, 8, 2, 128, 4, 4, 1)
    args4 = [_t(x).to(cuda_device, torch.bfloat16)
             for x in (q, pool_k, pool_v)] + \
        [_t(x).to(cuda_device) for x in (tbl, cl)] + [0]
    arrs = _paged_prefill_inputs(*PAGED_PREFILL_CASES["gqa_d128"][:9],
                                 PAGED_PREFILL_CASES["gqa_d128"][10])
    args6 = [_t(x).to(cuda_device, torch.bfloat16) for x in arrs[:3]] + \
        [_t(x).to(cuda_device) for x in arrs[3:]] + [0]
    kw = dict(sp=1, page_size=4)
    paged_decode.reset_launches()
    paged_prefill.reset_launches()
    n_threads, calls = 16, 25

    def body():
        for _ in range(calls):
            paged_decode.paged_decode_attention(*args4, **kw)
            paged_prefill.paged_prefill_attention(*args6, **kw)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=body) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    torch.cuda.synchronize()
    assert paged_decode.LAUNCHES == {"B4": n_threads * calls}
    assert paged_prefill.LAUNCHES == {"B6": n_threads * calls}


def _sample_on(device, logits, temp, top_k, top_p, keys):
    """``engine.sampling.sample`` at P = 1 on ``device`` for the rows of
    ``logits`` (B, V): the head's first column holds them, x picks it."""
    import types

    from repro_torch.configs.base import ModelConfig
    from repro_torch.dist.comm import SingleComm
    from repro_torch.engine import sampling
    from repro_torch.models.runtime import Runtime

    B, V = logits.shape
    cfg = ModelConfig(name="s", family="dense", num_layers=1, d_model=B,
                      num_heads=1, num_kv_heads=1, d_ff=8, vocab_size=V)
    rt = Runtime(comm=SingleComm(), st_cfg=st_torch.StarTrailConfig(
        seq_len=8, seq_scheme="contiguous"), device=device)
    table = torch.from_numpy(np.ascontiguousarray(logits.T)).to(device)
    x = torch.eye(B, device=device)[:, None]             # row b -> column b

    def rows(v, dt):
        return torch.full((B,), v, dtype=dt, device=device)

    return sampling.sample(
        rt, types.SimpleNamespace(table=table), x, cfg,
        temperature=rows(temp, torch.float32), top_k=rows(top_k, torch.int32),
        top_p=rows(top_p, torch.float32), keys=keys)[:, 0].cpu().numpy()


@pytest.mark.gpu
def test_sample_on_the_card_membership_and_determinism(cuda_device):
    """``sample`` on CUDA tensors at V = 32000: the CUDA generators' draws
    stay in the top 8 and in the top-0.4 nucleus, the same keys give the
    same tokens, other positions other tokens, temperature 0 the argmax."""
    from repro_torch.engine import sampling

    B, V = 4, 32000
    logits = np.repeat(3.0 * np.random.default_rng(0).normal(
        size=(1, V)).astype(np.float32), B, axis=0)
    top8 = set(np.argsort(logits[0])[-8:].tolist())
    probs = np.exp(logits[0].astype(float) - logits[0].max())
    probs /= probs.sum()
    order = np.argsort(-probs)
    nucleus = set(order[:int(np.searchsorted(np.cumsum(probs[order]), 0.4)
                             + 1)].tolist())

    def keys(step):
        return [sampling.fold_in(sampling.seed_key(b), step)
                for b in range(B)]

    k8 = [_sample_on(cuda_device, logits, 1.0, 8, 1.0, keys(i))
          for i in range(16)]
    assert set(np.concatenate(k8).tolist()) <= top8
    assert len(set(np.concatenate(k8).tolist())) > 1
    p4 = [_sample_on(cuda_device, logits, 1.0, 0, 0.4, keys(i))
          for i in range(16)]
    assert set(np.concatenate(p4).tolist()) <= nucleus
    again = _sample_on(cuda_device, logits, 1.0, 8, 1.0, keys(3))
    np.testing.assert_array_equal(again, k8[3])
    assert len({tuple(t) for t in k8}) > 1
    greedy = _sample_on(cuda_device, logits, 0.0, 8, 0.9, keys(0))
    assert (greedy == int(np.argmax(logits[0]))).all()


# ---------------------------------------------------------------------------
# The host KV tier's transfers (engine/kv_connector.py over
# paged_cache.read_pages / write_pages) on the card
# ---------------------------------------------------------------------------

def _card_connector(dev, capacity_pages=8, n_pages=8):
    """A connector over one rank's bf16 pools {'k','v'} (2, n_pages, 16, 8,
    80) on the card, as the engine builds it (pinned host pages)."""
    from repro_torch.engine import paged_cache
    from repro_torch.engine.kv_connector import KVConnector

    g = torch.Generator(device=dev).manual_seed(0)
    pools = {n: torch.randn((2, n_pages, 16, 8, 80), generator=g, device=dev,
                            dtype=torch.bfloat16) for n in ("k", "v")}
    shards = [[pools]]
    page_bytes = sum(t[:, 0].numel() * t.element_size()
                     for t in pools.values())
    conn = KVConnector(
        read_fn=lambda idx: paged_cache.read_pages(shards, idx),
        write_fn=lambda idx, data: paged_cache.write_pages(shards, idx, data),
        bucket=4, page_size=16, pages_per_shard=n_pages,
        page_bytes=page_bytes, capacity_bytes=capacity_pages * page_bytes,
        device=dev)
    return pools, conn


def _page(pools, p):
    return {n: t[:, p].clone() for n, t in pools.items()}


def _same_page(got, want):
    for n in want:
        assert torch.equal(got[n].to(want[n].device), want[n]), n


@pytest.mark.gpu
def test_host_tier_pinned_round_trip(cuda_device):
    """Spill to pinned staging, commit at flush, reload into other pages,
    export and inject: every page lands bit for bit."""
    pools, conn = _card_connector(cuda_device)
    want = {10 + p: _page(pools, p) for p in range(5)}
    for p in range(5):
        assert conn.spill(key=10 + p, page=(0, p), chain_tokens=16 * (p + 1))
    staged = [e for es in conn._staging.values() for e in es]
    assert all(t.is_pinned() for e in staged for t in e.data.values())
    assert not conn.has(10)
    assert conn.flush() == 5 and conn.has(10)
    for p in range(5):
        _same_page(conn.tier.get(10 + p).data, want[10 + p])
    for t in pools.values():
        t.zero_()
    # 5 pages over two transfer buckets, into other pages
    conn.reload([(10 + p, (0, 7 - p)) for p in range(5)])
    for p in range(5):
        _same_page(_page(pools, 7 - p), want[10 + p])
    blocks = conn.export([(0, 7), (0, 6)])
    assert all(t.is_pinned() for b in blocks for t in b.values())
    conn.inject([(0, 0), (0, 1)], blocks)
    _same_page(_page(pools, 0), want[10])
    _same_page(_page(pools, 1), want[11])
    s = conn.stats()
    assert (s["spill_pages"], s["reload_pages"], s["handoff_out_pages"],
            s["handoff_in_pages"]) == (5, 5, 2, 2)


@pytest.mark.gpu
def test_host_tier_spill_captures_value_before_page_reuse(cuda_device):
    """The spill's gather and copy are queued behind a long device sleep, so
    they have not run when the host overwrites the page right after
    ``spill()``: stream order must still give the committed copy the old
    value."""
    pools, conn = _card_connector(cuda_device)
    # a first spill pins a chunk of host pages, and pinning waits for the
    # work queued on the card: done here, before the sleep is queued, so
    # the measured spill below copies into a page already pinned
    conn.spill(key=6, page=(0, 1), chain_tokens=16)
    conn.flush()
    want = _page(pools, 2)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)           # ~25 ms of queued device time
    conn.spill(key=7, page=(0, 2), chain_tokens=16)
    for t in pools.values():
        t[:, 2].fill_(-1.0)                 # the page reused at once
    assert not conn._staging[0][0].done.query()   # still in flight
    conn.flush()
    _same_page(conn.tier.get(7).data, want)
    assert bool((pools["k"][:, 2] == -1.0).all())


@pytest.mark.gpu
def test_host_tier_evict_while_reloading(cuda_device):
    """A reload queued behind a long device sleep, then, at once, spills
    that LRU-evict the reloaded entries from a 4-page tier and new pinned
    buffers written over whatever memory was freed: the reloaded pages
    still land with the values the tier held."""
    pools, conn = _card_connector(cuda_device, capacity_pages=4)
    want = {20 + p: _page(pools, p) for p in range(4)}
    for p in range(4):
        conn.spill(key=20 + p, page=(0, p), chain_tokens=16)
    conn.flush()
    torch.cuda._sleep(50_000_000)
    conn.reload([(20 + p, (0, 4 + p)) for p in range(4)])
    for p in range(4):                      # displace every reloaded entry
        conn.spill(key=30 + p, page=(0, p), chain_tokens=16)
    conn.flush()
    assert not any(conn.has(20 + p) for p in range(4))
    assert conn.stats()["host_evicted_pages"] == 4
    junk = [torch.full((2, 4, 16, 8, 80), 7.0, dtype=torch.bfloat16,
                       pin_memory=True) for _ in range(8)]
    torch.cuda.synchronize()
    for p in range(4):
        _same_page(_page(pools, 4 + p), want[20 + p])
    del junk


@pytest.mark.gpu
def test_read_write_pages_every_data_replica(cuda_device):
    """``write_pages`` reaches each shard's rank in every data replica;
    ``read_pages`` takes replica 0's copy; -1 pads read as zeros."""
    from repro_torch.engine import paged_cache

    def pools():
        return {n: torch.zeros((2, 4, 16, 8, 80), device=cuda_device,
                               dtype=torch.bfloat16) for n in ("k", "v")}

    shards = [[pools(), pools()], [pools(), pools()]]   # 2 shards x 2 data
    data = {n: torch.randn((2, 4, 16, 8, 80), dtype=torch.bfloat16
                           ).pin_memory() for n in ("k", "v")}
    idx = np.array([5, 0, -1, 3])           # shard 1 page 1, shard 0 ...
    paged_cache.write_pages(shards, idx, data)
    for replica in range(2):
        for n in ("k", "v"):
            assert torch.equal(shards[1][replica][n][:, 1].cpu(),
                               data[n][:, 0])
            assert torch.equal(shards[0][replica][n][:, 0].cpu(),
                               data[n][:, 1])
            assert torch.equal(shards[0][replica][n][:, 3].cpu(),
                               data[n][:, 3])
    shards[1][1]["k"].fill_(9.0)            # replica 1 is not read
    got = paged_cache.read_pages(shards, idx)
    for n in ("k", "v"):
        assert torch.equal(got[n][:, [0, 1, 3]].cpu(), data[n][:, [0, 1, 3]])
        assert not got[n][:, 2].any()


def _small_serving_model(cuda_device):
    """The smoke h2o config widened to head size 32 (the kernels' smallest),
    seeded on the card."""
    from repro_torch.configs import registry
    from repro_torch.models.factory import build_model

    cfg = dataclasses.replace(registry.get_smoke("h2o-danube-1.8b"),
                              d_model=128, window=None,
                              param_dtype="bfloat16")
    return build_model(cfg, device=cuda_device, seed=0)


@pytest.mark.gpu
def test_engine_on_two_gloo_rank_processes_on_card(cuda_device):
    """Two gloo rank processes at (data, C, R) = (1, 1, 2) each serve an
    engine of their own on the card, holding their shards of the weights
    drawn from seed 0 there, through the CUDA kernels (B2 and B4 launched
    in each process): their streams equal the ThreadMesh engine's at the
    same plan and weights, a request joining mid-run."""
    import torch_serve_procs_ranks as ranks
    from repro_torch.dist.procs import ProcessMesh
    from repro_torch.engine import Engine, EngineConfig, Request
    from repro_torch.kernels import _build
    from repro_torch.plan import make_serve_plan

    model = _small_serving_model(cuda_device)
    plan = make_serve_plan(model.cfg, arch="h2o-danube-1.8b", n_devices=2,
                           c=1, decode_batch=2, page_size=16, max_len=256)
    eng = EngineConfig(pages_per_shard=32)
    rng = np.random.default_rng(1)
    reqs = [Request(f"r{i}", rng.integers(0, 256, n).tolist(), 6)
            for i, n in enumerate([40, 70, 25])]
    want = ranks.observe(Engine(model, plan, eng), reqs, "joined")["streams"]
    _build.library()               # one build, before the ranks load it
    got = ProcessMesh(1, 2, backend="gloo", timeout=120).run(
        ranks.serve_card, model.cfg, plan, eng, reqs, timeout=300)
    assert len(got) == 2
    for streams, launches in got:
        assert streams == want
        assert launches["B2"] > 0 and launches["B4"] > 0


@pytest.mark.gpu
def test_gateway_two_replicas_share_one_model_on_card(cuda_device):
    """Two unified replicas on the card share one ``Model``; each
    replica's streams equal a single engine's fed the same requests at the
    same steps (the same batches), and both prefix caches hit."""
    from repro_torch.engine import Engine, EngineConfig, Request
    from repro_torch.gateway import Gateway
    from repro_torch.plan import make_serve_plan

    model = _small_serving_model(cuda_device)
    plan = make_serve_plan(model.cfg, arch="h2o-danube-1.8b", replicas=2,
                           decode_batch=2, page_size=16, max_len=256,
                           prefix_cache=True)
    eng = EngineConfig(pages_per_shard=64)
    gw = Gateway(model, plan, eng)
    assert all(e.model is model for e in gw.engines)
    rng = np.random.default_rng(0)
    shared = [rng.integers(0, 256, 64).tolist() for _ in range(2)]
    reqs = [Request(f"r{i}", shared[i % 2] + rng.integers(0, 256, 20 + i)
                    .tolist(), 8) for i in range(6)]
    for i, r in enumerate(reqs):
        assert gw.add_request(r, session=f"s{i % 2}") == i % 2
    out = gw.run()
    m = gw.metrics_dict()
    assert m["routed"] == [3, 3] and m["affinity_hits"] == 4
    assert all(p["prefill_tokens_cached"] > 0 for p in m["per_replica"])
    for i in range(2):
        solo = Engine(model, dataclasses.replace(plan, replicas=1), eng)
        mine = [r for r in reqs if gw._owner[r.uid] == i]
        for r in mine:
            assert solo.add_request(r) is None
        got = solo.run()
        assert {r.uid: got[r.uid] for r in mine} == \
            {r.uid: out[r.uid] for r in mine}


@pytest.mark.gpu
def test_proc_replicas_seeded_on_card_hold_equal_weights(cuda_device):
    """Two spawned workers draw the weights from one seed on the card: the
    same bits as each other and as an in-process replica (digest), and
    the same greedy streams as the in-process replica."""
    from repro_torch.configs import registry
    from repro_torch.engine import EngineConfig
    from repro_torch.frontend.orchestrator import Orchestrator
    from repro_torch.frontend.protocol import make_worker_spec
    from repro_torch.frontend.worker import LocalReplica, ProcReplica
    from repro_torch.plan import make_serve_plan

    plan = make_serve_plan(registry.get_smoke("h2o-danube-1.8b"),
                           arch="h2o-danube-1.8b", decode_batch=2,
                           page_size=4, max_len=64, kernel_impl="ref",
                           block_impl="ref")
    spec = make_worker_spec(plan=plan, eng=EngineConfig(pages_per_shard=64),
                            init_seed=7)
    local = LocalReplica(0, spec)
    procs = [ProcReplica(i, spec) for i in range(2)]
    try:
        assert [p.digest() for p in procs] == [local.digest()] * 2
        reqs = [[(5 * i + j) % 97 + 1 for j in range(8 + i)]
                for i in range(4)]
        outs = []
        for reps in ([local], procs[:1]):
            orch = Orchestrator(reps)
            rids = [orch.submit(p, 6) for p in reqs]
            got = orch.run()
            outs.append([got[r] for r in rids])
        assert outs[0] == outs[1]
    finally:
        for p in procs:
            p.shutdown()
    assert all(not p.proc.is_alive() for p in procs)


# ---------------------------------------------------------------------------
# the MoE family on the card (smoke width, heads of 32, f32)
# ---------------------------------------------------------------------------

MOE_ARCHS = ["phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b"]


def _moe_smoke(arch):
    """The smoke MoE config with a head size the kernels take."""
    from repro_torch.configs import registry

    return dataclasses.replace(registry.get_smoke(arch), head_dim=32)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_engine_on_the_card_matches_cpu(cuda_device, arch):
    """A smoke MoE engine at P = 1 on the card (B2 per layer and prefill,
    B4 per layer and decode step) against the same engine on the CPU: the
    streams equal, every first-token hidden state within 2e-3."""
    import copy

    from repro_torch.engine import Engine, EngineConfig, Request
    from repro_torch.models.factory import build_model
    from repro_torch.plan import make_serve_plan

    cfg = _moe_smoke(arch)
    cpu = build_model(cfg, device="cpu", seed=0)
    rng = np.random.default_rng(2)
    reqs = [Request(f"m{i}", rng.integers(0, cfg.vocab_size,
                                          5 + 3 * i).tolist(), 3 + i)
            for i in range(3)]
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        engine = Engine(copy.deepcopy(cpu).to(dev), make_serve_plan(
            cfg, arch=arch, c=1, decode_batch=2, page_size=4, max_len=64),
            EngineConfig(pages_per_shard=32))
        hidden = {}
        engine.on_prefill = lambda uid, h: hidden.__setitem__(
            uid, h.float().cpu())
        for r in reqs:
            engine.add_request(r)
        flash_attention.reset_launches()
        paged_decode.reset_launches()
        streams = engine.run()
        L, m = cfg.num_layers, engine.metrics
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert flash_attention.LAUNCHES["B2"] == L * m.prefills
            assert paged_decode.LAUNCHES == {"B4": L * m.decode_steps}
        out[dev.type] = (streams, hidden)
    assert out["cuda"][0] == out["cpu"][0]
    for uid, h in out["cpu"][1].items():
        assert float((out["cuda"][1][uid] - h).abs().max()) < 2e-3, uid


@pytest.mark.gpu
@pytest.mark.parametrize("data,c", [(1, 1), (2, 2)], ids=["p1", "c2data2"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_step_matches_cpu(cuda_device, arch, data, c):
    """One train step of a smoke MoE model on the card and on the CPU from
    the same weights and batch, at P = 1 and on ``ThreadMesh(c=2, r=1,
    data=2)`` (experts split over the 2 data shards): loss, gradient norm
    and every updated parameter within 2e-3; B2 twice and B3 once per
    layer and rank (``attn_out``)."""
    import copy

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.factory import build_model
    from repro_torch.optim import adamw
    from repro_torch.plan import make_plan

    cfg = _moe_smoke(arch)
    cpu = build_model(cfg, device="cpu", seed=0)
    n = data * c * c
    plan = make_plan(cfg, ShapeConfig("t", 64, 2, "train"), n_devices=n,
                     data=data, c=c)
    batch = SyntheticLM(cfg, plan.shape_config(), seed=0,
                        sp_size=plan.sp_size).get_batch(0)
    adam = adamw.AdamWConfig(learning_rate=1e-3, warmup_steps=0)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = copy.deepcopy(cpu).to(dev)
        step, sh = plan.build_train_step(model, adam)
        flash_attention.reset_launches()
        _, m = step(adamw.init_state(sh["params"], adam),
                    {k: _t(v).to(dev) for k, v in batch.items()})
        if dev.type == "cuda":
            torch.cuda.synchronize()
            L = cfg.num_layers
            assert flash_attention.LAUNCHES == {
                "B1": 0, "B2": n * plan.r * 2 * L, "B3": n * plan.r * L}
        out[dev.type] = (m, [p.detach().cpu() for p in sh["params"]])
    (m_gpu, p_gpu), (m_cpu, p_cpu) = out["cuda"], out["cpu"]
    for key in ("loss", "grad_norm"):
        assert abs(float(m_gpu[key]) - float(m_cpu[key])) < 2e-3, key
    assert max(float((a - b).abs().max()) for a, b in zip(p_gpu, p_cpu)) \
        < 2e-3


# ---------------------------------------------------------------------------
# the xLSTM family on the card (smoke width, f32): no attention kernel
# ---------------------------------------------------------------------------

XLSTM = "xlstm-1.3b"


@pytest.mark.gpu
@pytest.mark.parametrize("n_devices", [1, 4])
def test_xlstm_legacy_on_the_card_matches_cpu(cuda_device, n_devices):
    """``--legacy`` of a smoke xLSTM model at P = 1 and at P = 4
    (ThreadMesh(c=2, r=1)) on the card against the CPU from the same
    weights: the tokens equal, the first decode step's hidden state within
    2e-4, no attention kernel launched."""
    import copy

    from repro_torch.configs import registry
    from repro_torch.launch.serve import legacy_start
    from repro_torch.models.factory import build_model
    from repro_torch.plan import make_serve_plan

    cfg = registry.get_smoke(XLSTM)
    cpu = build_model(cfg, device="cpu", seed=0)
    plan = make_serve_plan(cfg, arch=XLSTM, n_devices=n_devices,
                           c=2 if n_devices > 1 else 1)
    tokens = _t(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 32)))
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = copy.deepcopy(cpu).to(dev)
        flash_attention.reset_launches()
        ragged_prefill.reset_launches()
        tok, cache, decode = legacy_start(model, plan, tokens.to(dev), 4)
        cl = torch.full((2,), 32, dtype=torch.int32, device=dev)
        hidden = decode(cache, tok.long(), cl, return_hidden=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert not any(flash_attention.LAUNCHES.values())
            assert not any(ragged_prefill.LAUNCHES.values())
        out[dev.type] = (tok.cpu(), hidden.float().cpu())
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert float((out["cuda"][1] - out["cpu"][1]).abs().max()) < 2e-4


@pytest.mark.gpu
@pytest.mark.parametrize("data,c", [(1, 1), (1, 2)], ids=["p1", "c2"])
def test_xlstm_train_step_matches_cpu(cuda_device, data, c):
    """One train step of a smoke xLSTM model on the card and on the CPU
    from the same weights and batch, at P = 1 and on ThreadMesh(c=2, r=1):
    loss, gradient norm and every updated parameter within 2e-3."""
    import copy

    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.factory import build_model
    from repro_torch.optim import adamw
    from repro_torch.plan import make_plan

    cfg = registry.get_smoke(XLSTM)
    cpu = build_model(cfg, device="cpu", seed=0)
    plan = make_plan(cfg, ShapeConfig("t", 64, 2, "train"),
                     n_devices=data * c * c, data=data, c=c)
    batch = SyntheticLM(cfg, plan.shape_config(), seed=0,
                        seq_scheme=plan.seq_scheme,
                        sp_size=plan.sp_size).get_batch(0)
    adam = adamw.AdamWConfig(learning_rate=1e-3, warmup_steps=0)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = copy.deepcopy(cpu).to(dev)
        step, sh = plan.build_train_step(model, adam)
        _, m = step(adamw.init_state(sh["params"], adam),
                    {k: _t(v).to(dev) for k, v in batch.items()})
        out[dev.type] = (m, [p.detach().cpu() for p in sh["params"]])
    (m_gpu, p_gpu), (m_cpu, p_cpu) = out["cuda"], out["cpu"]
    for key in ("loss", "grad_norm"):
        assert abs(float(m_gpu[key]) - float(m_cpu[key])) < 2e-3, key
    assert max(float((a - b).abs().max()) for a, b in zip(p_gpu, p_cpu)) \
        < 2e-3


# ---------------------------------------------------------------------------
# the hybrid family on the card (smoke width, f32; its head size 16 is not
# one the kernels take, so attention runs the plain versions here)
# ---------------------------------------------------------------------------

JAMBA = "jamba-1.5-large-398b"


def _plain_kernels(plan):
    import dataclasses

    return dataclasses.replace(plan, kernel_impl="ref", block_impl="ref")


@pytest.mark.gpu
@pytest.mark.parametrize("n_devices", [1, 4])
def test_hybrid_legacy_on_the_card_matches_cpu(cuda_device, n_devices):
    """``--legacy`` of a smoke jamba model at P = 1 and at P = 4
    (ThreadMesh(c=2, r=1)) on the card against the CPU from the same
    weights: the first tokens equal, the first decode step's hidden state
    and every Mamba layer's conv and SSM state within 2e-4."""
    import copy

    from repro_torch.configs import registry
    from repro_torch.launch.serve import legacy_start
    from repro_torch.models.factory import build_model
    from repro_torch.plan import make_serve_plan

    cfg = registry.get_smoke(JAMBA)
    cpu = build_model(cfg, device="cpu", seed=0)
    plan = _plain_kernels(make_serve_plan(
        cfg, arch=JAMBA, n_devices=n_devices, c=2 if n_devices > 1 else 1))
    tokens = _t(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 32)))
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = copy.deepcopy(cpu).to(dev)
        tok, caches, decode = legacy_start(model, plan, tokens.to(dev), 4)
        cl = torch.full((2,), 32, dtype=torch.int32, device=dev)
        hidden = decode(caches, tok.long(), cl, return_hidden=True)
        states = [t.float().cpu() for layer in caches[-1]
                  for n, t in sorted(layer.items()) if n in ("conv", "state")]
        out[dev.type] = (tok.cpu(), hidden.float().cpu(), states)
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert float((out["cuda"][1] - out["cpu"][1]).abs().max()) < 2e-4
    assert len(out["cuda"][2]) == 12      # 6 Mamba layers: conv, state
    for a, b in zip(out["cuda"][2], out["cpu"][2]):
        assert float((a - b).abs().max()) < 2e-4 * max(
            float(b.abs().max()), 1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("data,c", [(1, 1), (1, 2)], ids=["p1", "c2"])
def test_hybrid_train_step_matches_cpu(cuda_device, data, c):
    """One train step of a smoke jamba model on the card and on the CPU
    from the same weights and batch, at P = 1 and on ThreadMesh(c=2, r=1)
    (the conv halo and the state correction between ranks): loss,
    gradient norm and every updated parameter within 2e-3."""
    import copy

    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.factory import build_model
    from repro_torch.optim import adamw
    from repro_torch.plan import make_plan

    cfg = registry.get_smoke(JAMBA)
    cpu = build_model(cfg, device="cpu", seed=0)
    plan = _plain_kernels(make_plan(cfg, ShapeConfig("t", 64, 2, "train"),
                                    n_devices=data * c * c, data=data, c=c))
    batch = SyntheticLM(cfg, plan.shape_config(), seed=0,
                        seq_scheme=plan.seq_scheme,
                        sp_size=plan.sp_size).get_batch(0)
    adam = adamw.AdamWConfig(learning_rate=1e-3, warmup_steps=0)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = copy.deepcopy(cpu).to(dev)
        step, sh = plan.build_train_step(model, adam)
        _, m = step(adamw.init_state(sh["params"], adam),
                    {k: _t(v).to(dev) for k, v in batch.items()})
        out[dev.type] = (m, [p.detach().cpu() for p in sh["params"]])
    (m_gpu, p_gpu), (m_cpu, p_cpu) = out["cuda"], out["cpu"]
    for key in ("loss", "grad_norm"):
        assert abs(float(m_gpu[key]) - float(m_cpu[key])) < 2e-3, key
    assert max(float((a - b).abs().max()) for a, b in zip(p_gpu, p_cpu)) \
        < 2e-3


# ---------------------------------------------------------------------------
# the encoder-decoder family on the card (smoke seamless widened to d_model
# 128, so its 4 heads of 32 run the kernels; f32, the CUDA-core kernels)
# ---------------------------------------------------------------------------

SEAMLESS = "seamless-m4t-large-v2"


def _seamless_cfg():
    import dataclasses

    from repro_torch.configs import registry

    return dataclasses.replace(registry.get_smoke(SEAMLESS), d_model=128)


@pytest.mark.gpu
@pytest.mark.parametrize("n_devices", [1, 4])
def test_encdec_legacy_on_the_card_matches_cpu(cuda_device, n_devices):
    """``--legacy`` of a smoke seamless model at P = 1 and at P = 4
    (ThreadMesh(c=2, r=1)) on the card (B2 in the encoder prefill, B1 and
    B5 in every decode step) against the CPU from the same weights and
    frames: the first tokens equal, each rank's ``enc_out`` and the first
    decode step's hidden state within 2e-4 of the largest magnitude."""
    import copy

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ragged_prefill as rp
    from repro_torch.launch.serve import legacy_start
    from repro_torch.models.factory import build_model
    from repro_torch.plan import make_serve_plan

    cfg = _seamless_cfg()
    cpu = build_model(cfg, device="cpu", seed=0)
    plan = make_serve_plan(cfg, arch=SEAMLESS, n_devices=n_devices,
                           c=2 if n_devices > 1 else 1)
    rng = np.random.default_rng(3)
    tokens = _t(rng.integers(0, cfg.vocab_size, (2, 16)))
    frames = _t(rng.standard_normal((2, 16, cfg.d_model), dtype=np.float32))
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = copy.deepcopy(cpu).to(dev)
        fa.reset_launches()
        rp.reset_launches()
        tok, caches, decode = legacy_start(model, plan, tokens.to(dev), 4,
                                           frames.to(dev))
        cl = torch.full((2,), 16, dtype=torch.int32, device=dev)
        hidden = decode(caches, tok.long(), cl, return_hidden=True)
        out[dev.type] = (tok.cpu(), hidden.float().cpu(),
                         [c["enc_out"].float().cpu() for c in caches],
                         dict(fa.LAUNCHES, **rp.LAUNCHES))
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert out["cuda"][3]["B2"] > 0 and out["cuda"][3]["B1"] > 0 \
        and out["cuda"][3]["B5"] > 0
    for a, b in [(out["cuda"][1], out["cpu"][1])] + list(zip(
            out["cuda"][2], out["cpu"][2])):
        assert float((a - b).abs().max()) < 2e-4 * max(
            float(b.abs().max()), 1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("data,c", [(1, 1), (1, 2)], ids=["p1", "c2"])
def test_encdec_train_step_matches_cpu(cuda_device, data, c):
    """One train step of a smoke seamless model on the card (B1, B2 and
    B3) and on the CPU from the same weights and batch (frames included),
    at P = 1 and on ThreadMesh(c=2, r=1) (the cross-attention's K/V
    gathered between ranks): loss, gradient norm and every updated
    parameter within 2e-3."""
    import copy

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.factory import build_model
    from repro_torch.optim import adamw
    from repro_torch.plan import make_plan

    cfg = _seamless_cfg()
    cpu = build_model(cfg, device="cpu", seed=0)
    plan = make_plan(cfg, ShapeConfig("t", 64, 2, "train"),
                     n_devices=data * c * c, data=data, c=c)
    batch = SyntheticLM(cfg, plan.shape_config(), seed=0,
                        seq_scheme=plan.seq_scheme,
                        sp_size=plan.sp_size).get_batch(0)
    adam = adamw.AdamWConfig(learning_rate=1e-3, warmup_steps=0)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = copy.deepcopy(cpu).to(dev)
        step, sh = plan.build_train_step(model, adam)
        _, m = step(adamw.init_state(sh["params"], adam),
                    {k: _t(v).to(dev) for k, v in batch.items()})
        out[dev.type] = (m, [p.detach().cpu() for p in sh["params"]])
    (m_gpu, p_gpu), (m_cpu, p_cpu) = out["cuda"], out["cpu"]
    for key in ("loss", "grad_norm"):
        assert abs(float(m_gpu[key]) - float(m_cpu[key])) < 2e-3, key
    assert max(float((a - b).abs().max()) for a, b in zip(p_gpu, p_cpu)) \
        < 2e-3


# ---------------------------------------------------------------------------
# the VLM prefix-LM on the card (smoke paligemma widened to heads of 256,
# the kernels' head size for the family; f32, the CUDA-core kernels)
# ---------------------------------------------------------------------------

PALIGEMMA = "paligemma-3b"


def _paligemma_cfg():
    import dataclasses

    from repro_torch.configs import registry

    return dataclasses.replace(registry.get_smoke(PALIGEMMA), d_model=256,
                               head_dim=256)


@pytest.mark.gpu
@pytest.mark.parametrize("n_devices", [1, 4])
def test_vlm_legacy_on_the_card_matches_cpu(cuda_device, n_devices):
    """``--legacy`` of a smoke paligemma model at head size 256 at P = 1
    and at P = 4 (ThreadMesh(c=2, r=1)) on the card (B2 in the prefill
    with its patch prefix, B5 in every decode step) against the CPU from
    the same weights, tokens and patches: the first tokens equal, the first
    decode step's hidden state within 2e-4 of the largest magnitude."""
    import copy

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ragged_prefill as rp
    from repro_torch.launch.serve import legacy_start
    from repro_torch.models.factory import build_model
    from repro_torch.plan import make_serve_plan

    cfg = _paligemma_cfg()
    cpu = build_model(cfg, device="cpu", seed=0)
    plan = make_serve_plan(cfg, arch=PALIGEMMA, n_devices=n_devices,
                           c=2 if n_devices > 1 else 1)
    rng = np.random.default_rng(3)
    tokens = _t(rng.integers(0, cfg.vocab_size, (2, 32)))
    patches = _t(rng.standard_normal((2, 32, cfg.d_model), dtype=np.float32))
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = copy.deepcopy(cpu).to(dev)
        fa.reset_launches()
        rp.reset_launches()
        tok, caches, decode = legacy_start(model, plan, tokens.to(dev), 4,
                                           patches=patches.to(dev))
        cl = torch.full((2,), 32, dtype=torch.int32, device=dev)
        hidden = decode(caches, tok.long(), cl, return_hidden=True)
        out[dev.type] = (tok.cpu(), hidden.float().cpu(),
                         dict(fa.LAUNCHES, **rp.LAUNCHES))
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert out["cuda"][2]["B2"] > 0 and out["cuda"][2]["B5"] > 0
    a, b = out["cuda"][1], out["cpu"][1]
    assert float((a - b).abs().max()) < 2e-4 * max(float(b.abs().max()), 1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("data,c", [(1, 1), (1, 2)], ids=["p1", "c2"])
def test_vlm_train_step_matches_cpu(cuda_device, data, c):
    """One train step of a smoke paligemma model at head size 256 on the
    card (B2 and B3 under the prefix-LM mask) and on the CPU from the same
    weights and batch (patches included), at P = 1 and on ThreadMesh(c=2,
    r=1) (the prefix spread over the zigzag shards): loss, gradient norm
    and every updated parameter within 2e-3."""
    import copy

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.factory import build_model
    from repro_torch.optim import adamw
    from repro_torch.plan import make_plan

    cfg = _paligemma_cfg()
    cpu = build_model(cfg, device="cpu", seed=0)
    plan = make_plan(cfg, ShapeConfig("t", 64, 2, "train"),
                     n_devices=data * c * c, data=data, c=c)
    batch = SyntheticLM(cfg, plan.shape_config(), seed=0,
                        seq_scheme=plan.seq_scheme,
                        sp_size=plan.sp_size).get_batch(0)
    assert batch["frontend_emb"].shape == (2, 64, cfg.d_model)
    adam = adamw.AdamWConfig(learning_rate=1e-3, warmup_steps=0)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = copy.deepcopy(cpu).to(dev)
        step, sh = plan.build_train_step(model, adam)
        _, m = step(adamw.init_state(sh["params"], adam),
                    {k: _t(v).to(dev) for k, v in batch.items()})
        out[dev.type] = (m, [p.detach().cpu() for p in sh["params"]])
    (m_gpu, p_gpu), (m_cpu, p_cpu) = out["cuda"], out["cpu"]
    for key in ("loss", "grad_norm"):
        assert abs(float(m_gpu[key]) - float(m_cpu[key])) < 2e-3, key
    assert max(float((a - b).abs().max()) for a, b in zip(p_gpu, p_cpu)) \
        < 2e-3


@pytest.mark.gpu
def test_dry_run_predicts_the_train_step(cuda_device):
    """``launch.dryrun``'s trace of a P = 1 train step (full-width
    h2o-danube-1.8b cut to 2 layers, seq 1024, batch 2 in 2 microbatches,
    ``attn_out``, ``kernel_impl='cuda'``) against the same step on the
    card: the parameters plus AdamW state it predicts equal the bytes of
    the live storages, and its ``peak_bytes_per_device`` lies within 0.5
    to 2 of ``torch.cuda.max_memory_allocated`` over the step."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models.factory import build_model
    from repro_torch.optim import adamw
    from repro_torch.plan import make_plan

    cfg = dataclasses.replace(registry.get("h2o-danube-1.8b"), num_layers=2)
    shape = ShapeConfig("t", 1024, 2, "train")
    plan = make_plan(cfg, shape, c=1, microbatches=2, kernel_impl="cuda",
                     block_impl="cuda")
    _, mem = dryrun.trace_step(cfg, plan)
    model = build_model(cfg, device=cuda_device, seed=0)
    adam = adamw.AdamWConfig(learning_rate=1e-3, warmup_steps=0,
                             state_dtype=cfg.opt_dtype)
    step, sh = plan.build_train_step(model, adam)
    opt = adamw.init_state(sh["params"], adam)
    live = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for t in list(model.parameters()) + opt["mu"] + opt["nu"]}
    assert mem["alias_bytes"] - 4 == sum(live.values())   # less the step
    batch = {n: torch.randint(0, cfg.vocab_size, (2, 1024), dtype=torch.int32,
                              device=cuda_device)
             for n in ("tokens", "labels")}
    step(opt, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(opt, batch)
    torch.cuda.synchronize()
    ratio = mem["peak_bytes_per_device"] / torch.cuda.max_memory_allocated()
    assert 0.5 <= ratio <= 2.0, ratio


@pytest.mark.gpu
def test_pipelined_ring_is_bitexact_on_the_card(cuda_device):
    """``chip_smoke.py``'s ring shape (P = 8 as ``ThreadMesh(2, 2)``
    threads, N = 2048, 32q/8kv heads of 80, bf16, causal, window 1024):
    every rank's explicit forward and backward with the pipelined issue
    order (the copies on the ranks' comm streams, each started before the
    block kernel that does not need it) equal the unpipelined ones bit for
    bit, and each order launches B2 and B3 once a ring step of a rank."""
    from repro_torch.dist.comm import ThreadMesh

    n, c, r = 2048, 2, 2
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v, do = (torch.randn((1, n, h, 80), generator=g,
                               device=cuda_device).bfloat16()
                   for h in (32, 8, 8, 32))
    out = {}
    for pipeline in (True, False):
        cfg = st_torch.StarTrailConfig(seq_len=n, window=1024,
                                       block_impl="cuda", pipeline=pipeline)

        def rank_fn(comm):
            gi, ji, ti = (comm.axis_index(a) for a in cfg.axes)
            pos = st_torch.shard_positions((gi * r + ji) * c + ti, n,
                                           c * c * r, "zigzag")
            pos = pos.to(cuda_device)
            o, res = st_torch.startrail_forward(
                *(t[:, pos].contiguous() for t in (q, k, v)), cfg, comm)
            return (o,) + tuple(st_torch.startrail_backward(
                res, o, do[:, pos].contiguous(), cfg, comm))

        flash_attention.reset_launches()
        out[pipeline] = ThreadMesh(c, r).run(rank_fn, timeout=300)
        torch.cuda.synchronize()
        assert flash_attention.LAUNCHES == {"B1": 0, "B2": 8 * r,
                                            "B3": 8 * r}
    for a, b in zip(out[True], out[False]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
def test_ppermute_start_outlives_the_senders_tensor(cuda_device):
    """The stream hazard the split-phase ppermute guards against: each
    rank's comm stream is held ~25 ms by a device sleep, so its copy runs
    late; meanwhile the sender drops its tensor (its slot taken by a second
    transfer), allocates the same size and overwrites it on the compute
    stream. The received values are still the sent ones: ``record_stream``
    keeps the block from the allocator until the copy has run."""
    from repro_torch.dist.comm import ThreadMesh

    perm = [(0, 1), (1, 0)]

    n = 1 << 20

    def rank_fn(comm, hold):
        stream = comm.comm_stream(cuda_device)
        with torch.cuda.stream(stream):
            torch.cuda._sleep(hold)
        x = torch.full((n,), float(comm.rank + 1), device=cuda_device)
        h = comm.ppermute_start(x, "sp_ring", perm)
        h2 = comm.ppermute_start(torch.zeros(4, device=cuda_device),
                                 "sp_ring", perm)
        del x
        # enough blocks of x's size that the allocator would hand x's out
        ys = [torch.empty((n,), device=cuda_device).fill_(-7.0)
              for _ in range(32)]
        pending = not stream.query()
        got = h.wait()
        h2.wait()
        return got.clone(), ys, pending

    mesh = ThreadMesh(1, 2)
    # a first round loads every kernel and caches the blocks: a first
    # launch (lazy module loading) or a cudaMalloc waits for the device
    # and would close the window the second round needs
    mesh.run(lambda comm: rank_fn(comm, 0), timeout=60)
    torch.cuda.synchronize()
    res = mesh.run(lambda comm: rank_fn(comm, 100_000_000), timeout=60)
    torch.cuda.synchronize()
    for rank, (got, ys, pending) in enumerate(res):
        assert pending, "the copy ran before the overwrites: no hazard made"
        assert bool((got == float(2 - rank)).all()), rank
        assert all(bool((y == -7.0).all()) for y in ys)


@pytest.mark.gpu
def test_overlap_report_times_the_copies_on_the_card(cuda_device):
    """``overlap_report`` on the card (smoke h2o, P = 8 at (2, 2)): the
    issue-log counts of the CPU run, and a timed fraction in [0, 1] from
    the comm streams' device-to-device copies."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.obs import commlog
    from repro_torch.plan import make_plan

    cfg = dataclasses.replace(registry.get_smoke("h2o-danube-1.8b"),
                              head_dim=32)
    plan = make_plan(cfg, ShapeConfig("t", 256, 1, "train"), n_devices=8,
                     c=2, comm_chunks=1)
    rep = commlog.overlap_report(cfg, plan, device=cuda_device)
    cpu = commlog.overlap_report(cfg, plan, device="cpu")
    for key in ("overlap_fraction", "dots_total", "permutes_total",
                "permutes_with_overlap_window", "backward"):
        assert rep[key] == cpu[key], key
    for timed in (rep["timed"], rep["timed_queued"]):
        assert timed["copies"] > 0 and timed["copy_ms"] > 0
        assert 0.0 <= timed["timed_overlap_fraction"] <= 1.0
    assert rep["timed_queued"]["host_ahead"]
    assert cpu["timed"] is None and cpu["timed_queued"] is None


@pytest.mark.gpu
def test_ring_issues_without_a_host_sync(cuda_device):
    """The ring's forward and backward (P = 1 here) issue their work and
    return while a device sleep queued before them still runs: no call on
    the path waits for the device (a blocking copy of the positions would
    synchronise the stream at every ring step, and the comm streams'
    copies could never run beside a block kernel)."""
    from repro_torch.dist.comm import SingleComm

    cfg = st_torch.StarTrailConfig(seq_len=1024, block_impl="cuda")
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, do = (torch.randn((1, 1024, h, 80), generator=g,
                               device=cuda_device).bfloat16()
                   for h in (8, 2, 2, 8))
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)          # cycles, ~0.2 s
    o, res = st_torch.startrail_forward(q, k, v, cfg, SingleComm())
    st_torch.startrail_backward(res, o, do, cfg, SingleComm())
    assert not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
