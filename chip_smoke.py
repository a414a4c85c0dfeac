#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (``{"phase": ...}``):

  1. device   the card's name and ``nvidia-smi`` name / power limit
  2. build    nvcc of ``src/repro_torch/csrc/*.cu`` for sm_90a: seconds and
              the ``-Xptxas -v`` register / shared-memory / spill summary
  3. kernels  each CUDA kernel against its plain PyTorch version on the card
              (B1, B2, B3 at the 1024-token shapes, B2 and B3 again at the
              training shape, seq 4096, B4 at a decode step), and timed (CUDA events, median of bursts after warm-up)
              beside the plain version, a PyTorch library call where one
              computes the same function, and the card's bound for the work:
              B1, B2 and B4 at the serving shapes, B3 (and B2 again) at the
              training shape, seq 4096
  4. ring     StarTrail on a ThreadMesh(c=2, r=2): P = 8 ranks as threads
              on the one card, N = 2048 tokens of 32q/8kv heads of 80,
              bf16, causal + window; each rank runs the forward (B2 in
              every ring step) and then the backward (B3 in every ring
              step) explicitly; o and the gradients are held against plain
              full attention of the sequence and its autograd gradients
  5. engine   the serving engine at the full width of h2o-danube-1.8b
              (24 layers, seeded random bf16 weights): 8 greedy requests,
              prompts staggered over 64-1024 tokens, 32 new tokens each.
              Each prefill runs StarTrail at P = 1, one ring step per layer
              through B2; each decode step runs B4 once per layer
  6. engine_check  one prompt's next-token hidden state and logits under
              the CUDA kernels against the same engine on the plain versions
  7. local    the same prompt's prefill under the local-mode attention
              (``Runtime(attention_impl='local')``: one block per layer
              through B1), held against the engine's StarTrail prefill
  8. profile  ``torch.profiler`` over the engine with 4 slots of 1024-token
              prompts: one prefill plus decode step, then 8 decode steps;
              host and device ms per step, device idle share, top kernels
  9. train    the full-width model trains through ``train.trainer.train``
              with a plan from ``make_plan(c=1)``: seq 4096, batch 1, bf16,
              AdamW (f32 moments, lr 1e-3, no warmup), 6 steps on one
              repeated ``SyntheticLM`` batch. Each step runs, per layer,
              one StarTrail ring step forward (B2) and backward (B3); the
              loss must be finite and fall
 10. train_check  one loss and gradient of the same model at seq 1024
              under the CUDA kernels against the plain versions
 11. train_profile  ``torch.profiler`` over one full-width train step

The paths are phases 4, 5, 7 and 9: the launch counters are set to 0 just
before each and read just after, and each must launch exactly the kernels
it runs (B2 and B3 in the ring; B2 and B4 in the engine; B1 in the local
prefill; B2 and B3 in the train loop). Comparison, timing and profiling
launches are not counted. The kernels line's ``launches`` is each kernel's
count on the path that runs it (the engine for B2 and B4, the local
prefill for B1, the train loop for B3); ``launches_by_path`` gives every
path's counts. The last three lines are the card's ``nvidia-smi`` name and
power limit, the kernels' JSON line and ``{"ok": true, "device": {...}}``.
Any failed check exits non-zero before the last line; so does a machine
without a CUDA card, or a directory without the rest of the repository.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": 2e-5, "bfloat16": 1e-4}       # see phase_kernels
NEG_INF = -1e30
BWD_TOL = 3e-4                                   # see phase_kernels
REPLACES = {
    "B1": "src/repro/kernels/flash_attention.py:125",
    "B2": "src/repro/kernels/flash_attention.py:148",
    "B3": "src/repro/kernels/flash_attention.py:440",
    "B4": "src/repro/kernels/paged_decode.py:48",
}
SOURCES = {"B1": "src/repro_torch/csrc/flash_fwd.cu",
           "B2": "src/repro_torch/csrc/flash_fwd.cu",
           "B3": "src/repro_torch/csrc/flash_bwd.cu",
           "B4": "src/repro_torch/csrc/paged_decode.cu"}
ARCH = "h2o-danube-1.8b"


class CheckFailed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def time_ms(fn, reps=20, inner=5):
    """Median over ``reps`` bursts of ``inner`` back-to-back calls, per
    call, from CUDA events (after two warm-up bursts)."""
    import torch

    for _ in range(2 * inner):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def partial_err(o, lse, o_ref, lse_ref, tol):
    """(largest |o - o_ref| and |lse - lse_ref| over live rows, whether
    every value is within ``tol`` absolute plus ``tol`` relative, as the
    tests' assert_allclose, and whether every dead row is exact (o = 0,
    lse = -1e30), the number of dead rows)."""
    live = lse_ref > NEG_INF / 2
    pairs = [(o, o_ref), (lse[live], lse_ref[live])]
    err = max(float((a - b).abs().max()) if a.numel() else 0.0
              for a, b in pairs)
    within = all(bool(((a - b).abs() <= tol + tol * b.abs()).all())
                 for a, b in pairs)
    dead = ~live
    o_dead = dead.transpose(1, 2)                    # (B, S, H)
    exact = bool((lse[dead] == NEG_INF).all()) and \
        bool((o[o_dead] == 0).all())
    return err, within and exact, int(dead.sum())


# ---------------------------------------------------------------------------
# phase 3: kernels
# ---------------------------------------------------------------------------

def _zigzag(rank, n, p):
    from repro_torch.core import startrail as st

    return st.shard_positions(rank, n, p, "zigzag")


def fwd_cases():
    """B1/B2 inputs at the prefill shape: q (1,1024,32,80), k/v (1,1024,8,80)."""
    import torch

    S = 1024
    ar = torch.arange(S, dtype=torch.int32)
    return {
        # name: (pos_q, pos_k, window)
        "causal_w4096": (ar, ar, 4096),
        "window256": (ar, ar, 256),
        "dead_block": (ar, ar + 64, 4096),   # query rows 0..63 see no key
        "zigzag": (_zigzag(1, 2 * S, 2), _zigzag(0, 2 * S, 2), 4096),
    }


def fwd_inputs(dtype, dev, seed=0):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((1, 1024, 32, 80), generator=g, device=dev)
    k = torch.randn((1, 1024, 8, 80), generator=g, device=dev)
    v = torch.randn((1, 1024, 8, 80), generator=g, device=dev)
    o_acc = torch.randn((1, 1024, 32, 80), generator=g, device=dev)
    lse_acc = torch.randn((1, 32, 1024), generator=g, device=dev) * 3
    # the running accumulator has seen nothing yet on some rows
    o_acc[:, :96] = 0.0
    lse_acc[:, :, :96] = NEG_INF
    return [t.to(dtype) for t in (q, k, v)], o_acc, lse_acc


def visible_pairs(pos_q, pos_k, window):
    from repro_torch.kernels import ref

    return int(ref.make_mask(pos_q, pos_k, causal=True,
                             window=window).sum())


def bwd_cases():
    """B3 inputs at the 1024-token shape: q (1,Sq,32,80), k/v (1,1024,8,80)."""
    import torch

    S = 1024
    ar = torch.arange(S, dtype=torch.int32)
    return {
        # name: (pos_q, pos_k, window)
        "causal_w4096": (ar, ar, 4096),
        "window256": (ar, ar, 256),
        "dead_block": (ar, ar + 64, 4096),   # query rows 0..63 see no key
        "zigzag": (_zigzag(1, 2 * S, 2), _zigzag(0, 2 * S, 2), 4096),
        "ragged_sq1000": (ar[:1000], ar, 4096),
    }


def bwd_inputs(pos_q, pos_k, window, dtype, dev, seed=0):
    """q, k, v, do in ``dtype`` and the global lse and delta of full
    attention over the block (delta from o rounded to q's dtype, as
    ``core.startrail.startrail_backward`` computes it)."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(seed)
    sq, sk = pos_q.numel(), pos_k.numel()
    q = torch.randn((1, sq, 32, 80), generator=g, device=dev).to(dtype)
    k = torch.randn((1, sk, 8, 80), generator=g, device=dev).to(dtype)
    v = torch.randn((1, sk, 8, 80), generator=g, device=dev).to(dtype)
    do = torch.randn((1, sq, 32, 80), generator=g, device=dev).to(dtype)
    o, lse = fa.flash_attention_fwd_plain(q, k, v, pos_q, pos_k,
                                          window=window)
    delta = torch.einsum("bshd,bshd->bhs", do.float(),
                         o.to(dtype).float()).contiguous()
    return q, k, v, do, lse, delta


def grad_err(got, want, lse, tol):
    """(largest |g - g_ref| over dq, dk, dv, whether every value is within
    ``tol`` absolute plus ``tol`` relative and every dead row's dq is
    exactly 0, the number of dead rows)."""
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    within = all(bool(((a - b).abs() <= tol + tol * b.abs()).all())
                 for a, b in zip(got, want))
    dead = (lse <= NEG_INF / 2).transpose(1, 2)      # (B, Sq, H)
    return err, within and bool((got[0][dead] == 0).all()), int(dead.sum())


def bwd_work(q, k, pairs):
    """(bytes, flops) of B3: q, k, v, do, lse, delta and the positions in
    once, dq, dk, dv out in f32; 10*D FLOPs per visible pair and query head
    (the recomputed scores, dp, dq, dk, dv)."""
    _, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() \
        + 2 * hq * sq * 4 + (sq + sk) * 4 + (q.numel() + 2 * k.numel()) * 4
    return nbytes, 10 * d * hq * pairs


def sdpa_bwd_ms(q, k, v, do):
    """The autograd backward alone of ``scaled_dot_product_attention``
    (causal, GQA) on the same inputs: the library yardstick of B3."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)
    dot = do.transpose(1, 2)
    return time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                               retain_graph=True),
                   reps=10, inner=2)


def paged_cases():
    # name: (sp, rank, window, cache_len per row (row 3 inactive))
    return {
        "sp1": (1, 0, None, [1023, 520, 7, 0]),
        "sp1_window256": (1, 0, 256, [1023, 700, 300, 0]),
        "sp2_rank1": (2, 1, 4096, [2047, 1000, 40, 0]),
        "decode_1k": (1, 0, 4096, [1023, 1010, 1000, 990]),
    }


def paged_inputs(dev, sp, cache_len, seed=0):
    """q (4,1,32,80) bf16; pool (512,16,8,80) bf16; table (4,64): distinct
    pages for the blocks each row has written, -1 past them, so the last
    page of a row is partial; a row with cache_len 0 is an inactive slot."""
    import numpy as np
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((4, 1, 32, 80), generator=g, device=dev).bfloat16()
    pool_k = torch.randn((512, 16, 8, 80), generator=g, device=dev).bfloat16()
    pool_v = torch.randn((512, 16, 8, 80), generator=g, device=dev).bfloat16()
    rng = np.random.default_rng(seed)
    perm = rng.permutation(512)
    table = np.full((4, 64), -1, np.int32)
    used = 0
    rank = 1 if sp > 1 else 0
    for b, cl in enumerate(cache_len):
        if cl == 0:
            continue
        blocks = cl // 16 + 1           # global blocks 0 .. cl // 16
        n_local = min(64, (blocks - rank + sp - 1) // sp)
        table[b, :n_local] = perm[used:used + n_local]
        used += n_local
    return (q, pool_k, pool_v, torch.from_numpy(table).to(dev),
            torch.tensor(cache_len, dtype=torch.int32, device=dev))


def paged_work(table, cache_len, sp, rank, window, ps=16, hkv=8, d=80,
               hq=32):
    """(bytes, flops) this data needs: the live pages' K and V read once,
    and 4*D FLOPs per visible key and query head."""
    live_pages = vis = 0
    for b in range(table.shape[0]):
        cl = int(cache_len[b])
        for w in range(table.shape[1]):
            base = (w * sp + rank) * ps
            if table[b, w] < 0 or base > cl:
                continue
            if window is not None and cl - (base + ps - 1) >= window:
                continue
            live_pages += 1
            for p in range(base, base + ps):
                if p <= cl and (window is None or cl - p < window):
                    vis += 1
    kv = 2 * live_pages * ps * hkv * d * 2
    io = (4 * hq * d * 2 + table.size * 4 + table.shape[0] * 4
          + 4 * hq * d * 4 + 4 * hq * 4)
    return kv + io, 4 * d * hq * vis


def phase_kernels(dev):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode as pd

    rows = {n: {"name": n, "route": "cuda", "source": SOURCES[n],
                "replaces": REPLACES[n], "max_abs_err": 0.0}
            for n in ("B1", "B2", "B3", "B4")}
    checked = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        (q, k, v), o_acc, lse_acc = fwd_inputs(dtype, dev)
        for case, (pq, pk, window) in fwd_cases().items():
            pq, pk = pq.to(dev), pk.to(dev)
            for name, acc in (("B1", ()), ("B2", (o_acc, lse_acc))):
                o, lse = fa.flash_attention_fwd(q, k, v, pq, pk, *acc,
                                                window=window)
                torch.cuda.synchronize()
                o_p, lse_p = fa.flash_attention_fwd_plain(
                    q, k, v, pq, pk, *acc, window=window)
                err, ok, n_dead = partial_err(o, lse, o_p, lse_p, TOL[dname])
                check(ok, f"{name} {case} {dname}: max err {err} (tol "
                          f"{TOL[dname]}) or a dead row not exact")
                if case == "dead_block" and name == "B1":
                    check(n_dead >= 64 * 32, f"dead_block: {n_dead} dead")
                rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                                err)
                checked.append(f"{name}/{case}/{dname}")
        for case, (pq, pk, window) in bwd_cases().items():
            pq, pk = pq.to(dev), pk.to(dev)
            args = bwd_inputs(pq, pk, window, dtype, dev)
            got = fa.flash_attention_bwd(*args, pq, pk, window=window)
            torch.cuda.synchronize()
            want = fa.flash_attention_bwd_plain(*args, pq, pk, window=window)
            err, ok, n_dead = grad_err(got, want, args[4], BWD_TOL)
            check(ok, f"B3 {case} {dname}: max err {err} (tol {BWD_TOL}) "
                      f"or a dead row's dq not exactly 0")
            if case == "dead_block":
                check(n_dead >= 64 * 32, f"B3 dead_block: {n_dead} dead")
            again = fa.flash_attention_bwd(*args, pq, pk, window=window)
            check(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
                  f"B3 {case} {dname}: two runs differ (no atomics: they "
                  f"must give the same bits)")
            rows["B3"]["max_abs_err"] = max(rows["B3"]["max_abs_err"], err)
            checked.append(f"B3/{case}/{dname}")
    for case, (sp, rank, window, cls) in paged_cases().items():
        q, pk_, pv_, table, cl = paged_inputs(dev, sp, cls)
        kw = dict(sp=sp, page_size=16, window=window)
        o, lse = pd.paged_decode_attention(q, pk_, pv_, table, cl, rank, **kw)
        torch.cuda.synchronize()
        o_p, lse_p = pd.paged_decode_attention_plain(q, pk_, pv_, table, cl,
                                                     rank, **kw)
        err, ok, _ = partial_err(o, lse, o_p, lse_p, TOL["bfloat16"])
        check(ok, f"B4 {case}: max err {err} or a dead row not exact")
        if cls[-1] == 0:
            check(bool((lse[3] == NEG_INF).all()), f"B4 {case}: inactive")
        rows["B4"]["max_abs_err"] = max(rows["B4"]["max_abs_err"], err)
        checked.append(f"B4/{case}/bfloat16")

    # timing at the engine's shapes: a 1024-token prefill (bf16, causal,
    # window 4096) and a 4-slot decode step at ~1K context
    (q, k, v), o_acc, lse_acc = fwd_inputs(torch.bfloat16, dev)
    pq = torch.arange(1024, dtype=torch.int32, device=dev)
    pairs = visible_pairs(pq, pq, 4096)
    flops = 4 * 80 * 32 * pairs
    io = sum(t.numel() * t.element_size() for t in (q, k, v, pq, pq)) \
        + 1024 * 32 * 80 * 4 + 32 * 1024 * 4
    acc_io = o_acc.numel() * 4 + lse_acc.numel() * 4
    mask = (pq[None, :] <= pq[:, None])
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kt_r = kt.repeat_interleave(4, dim=1)
    vt_r = vt.repeat_interleave(4, dim=1)
    timing = {
        "B1": dict(
            ms=time_ms(lambda: fa.flash_attention_fwd(q, k, v, pq, pq,
                                                      window=4096)),
            plain_ms=time_ms(lambda: fa.flash_attention_fwd_plain(
                q, k, v, pq, pq, window=4096)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt_r, vt_r, attn_mask=mask)),
            work=(io, flops, "bfloat16")),
        "B2": dict(
            ms=time_ms(lambda: fa.flash_attention_fwd(
                q, k, v, pq, pq, o_acc, lse_acc, window=4096)),
            plain_ms=time_ms(lambda: fa.flash_attention_fwd_plain(
                q, k, v, pq, pq, o_acc, lse_acc, window=4096)),
            library_ms=None, work=(io + acc_io, flops, "bfloat16")),
    }
    sp, rank, window, cls = paged_cases()["decode_1k"]
    qd, pk_, pv_, table, cl = paged_inputs(dev, sp, cls)
    nb, nf = paged_work(table.cpu().numpy(), cl.cpu().numpy(), sp, rank,
                        window)
    kw = dict(sp=sp, page_size=16, window=window)
    timing["B4"] = dict(
        ms=time_ms(lambda: pd.paged_decode_attention(qd, pk_, pv_, table, cl,
                                                     rank, **kw)),
        plain_ms=time_ms(lambda: pd.paged_decode_attention_plain(
            qd, pk_, pv_, table, cl, rank, **kw)),
        library_ms=None, work=(nb, nf, "bfloat16"))
    # the training shape: seq 4096, bf16, causal (window 4096 is inert)
    g = torch.Generator(device=dev).manual_seed(3)
    S = TRAIN_SEQ
    q = torch.randn((1, S, 32, 80), generator=g, device=dev).bfloat16()
    k = torch.randn((1, S, 8, 80), generator=g, device=dev).bfloat16()
    v = torch.randn((1, S, 8, 80), generator=g, device=dev).bfloat16()
    do = torch.randn((1, S, 32, 80), generator=g, device=dev).bfloat16()
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    o, lse = fa.flash_attention_fwd_plain(q, k, v, pos, pos, window=4096)
    delta = torch.einsum("bshd,bshd->bhs", do.float(),
                         o.bfloat16().float()).contiguous()
    o_acc = torch.zeros((1, S, 32, 80), device=dev)
    lse_acc = torch.full((1, 32, S), NEG_INF, device=dev)
    pairs = visible_pairs(pos, pos, 4096)
    bargs = (q, k, v, do, lse, delta, pos, pos)
    # both kernels against their plain versions at the shape the train step
    # launches them at, before they are timed there
    got = fa.flash_attention_bwd(*bargs, window=4096)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(*bargs, window=4096)
    b3_err, ok, _ = grad_err(got, want, lse, BWD_TOL)
    check(ok, f"B3 train_seq{S} bfloat16: max err {b3_err} (tol {BWD_TOL})")
    rows["B3"]["max_abs_err"] = max(rows["B3"]["max_abs_err"], b3_err)
    checked.append(f"B3/train_seq{S}/bfloat16")
    del got, want
    o2, lse2 = fa.flash_attention_fwd(q, k, v, pos, pos, o_acc, lse_acc,
                                      window=4096)
    torch.cuda.synchronize()
    o2_p, lse2_p = fa.flash_attention_fwd_plain(q, k, v, pos, pos, o_acc,
                                                lse_acc, window=4096)
    b2_err, ok, _ = partial_err(o2, lse2, o2_p, lse2_p, TOL["bfloat16"])
    check(ok, f"B2 train_seq{S} bfloat16: max err {b2_err} (tol "
              f"{TOL['bfloat16']}) or a dead row not exact")
    rows["B2"]["max_abs_err"] = max(rows["B2"]["max_abs_err"], b2_err)
    checked.append(f"B2/train_seq{S}/bfloat16")
    del o2, lse2, o2_p, lse2_p
    try:
        lib_ms = sdpa_bwd_ms(q, k, v, do)
    except RuntimeError as e:      # no SDPA backend for these inputs
        lib_ms = None
        emit("kernels_note", library_B3=f"SDPA backward refused: {e}")
    timing["B3"] = dict(
        ms=time_ms(lambda: fa.flash_attention_bwd(*bargs, window=4096),
                   reps=10, inner=2),
        plain_ms=time_ms(lambda: fa.flash_attention_bwd_plain(
            *bargs, window=4096), reps=5, inner=2),
        library_ms=lib_ms, work=(*bwd_work(q, k, pairs), "bfloat16"))
    fwd_io = sum(t.numel() * t.element_size() for t in (q, k, v, pos, pos)) \
        + 2 * (o_acc.numel() + lse_acc.numel()) * 4
    b2_4096 = dict(
        ms=time_ms(lambda: fa.flash_attention_fwd(
            q, k, v, pos, pos, o_acc, lse_acc, window=4096), reps=10,
            inner=2),
        plain_ms=time_ms(lambda: fa.flash_attention_fwd_plain(
            q, k, v, pos, pos, o_acc, lse_acc, window=4096), reps=5,
            inner=2),
        max_abs_err=b2_err)
    b2_4096["bound_ms"], b2_4096["bound_by"] = bound(
        fwd_io, 4 * 80 * 32 * pairs, "bfloat16")
    for name, t in timing.items():
        b_ms, b_by = bound(*t.pop("work"))
        rows[name].update(t, bound_ms=b_ms, bound_by=b_by,
                          tol=BWD_TOL if name == "B3" else TOL)
    emit("kernels", checked=len(checked),
         tolerances="forward: f32 inputs 2e-5 (the JAX kernel tests' own); "
                    "bf16 inputs, upcast to f32 in both versions, 1e-4; "
                    "B3: 3e-4 (the JAX test_bwd_matches_ref bound); dead "
                    "rows exact",
         timing_shapes={"B1/B2": "q (1,1024,32,80) bf16, causal, window "
                                 "4096",
                        "B3, B2_seq4096": "q (1,4096,32,80), k/v "
                                          "(1,4096,8,80) bf16, causal, "
                                          "window 4096",
                        "B4": "q (4,1,32,80) bf16, pool (512,16,8,80), W "
                              "64, ~1K context"},
         library={"B1": "scaled_dot_product_attention, o only, kv heads "
                        "repeated beforehand",
                  "B3": "autograd backward of scaled_dot_product_attention"
                        "(is_causal, enable_gqa), timed alone"},
         B2_seq4096=b2_4096, B3_seq4096_max_abs_err=b3_err,
         **{n: {k: r[k] for k in ("ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by", "max_abs_err")}
            for n, r in rows.items()})
    return rows


# ---------------------------------------------------------------------------
# phase 4: StarTrail forward and backward on a P = 8 ThreadMesh on the card
# ---------------------------------------------------------------------------

# The ring's gradients against autograd of plain attention in f32 from the
# same bf16 inputs. Both see the bf16 inputs exactly; the ring also rounds o
# to bf16 before delta = rowsum(do * o) (as the model's backward does), which
# moves ds by up to a bf16 ulp of delta (2^-8 relative), so allow 1e-2 of
# each gradient's largest magnitude.
RING_GRAD_TOL = 1e-2


def phase_ring(dev):
    import torch

    from repro_torch.core import startrail as st
    from repro_torch.dist.comm import ThreadMesh
    from repro_torch.kernels import ref

    N, window, c, r = 2048, 1024, 2, 2
    mesh = ThreadMesh(c, r)
    p = mesh.size
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((1, N, 32, 80), generator=g, device=dev).bfloat16()
    k = torch.randn((1, N, 8, 80), generator=g, device=dev).bfloat16()
    v = torch.randn((1, N, 8, 80), generator=g, device=dev).bfloat16()
    do = torch.randn((1, N, 32, 80), generator=g, device=dev).bfloat16()
    cfg = st.StarTrailConfig(seq_len=N, seq_scheme="zigzag", causal=True,
                             window=window, block_impl="cuda")

    def rank_fn(comm):
        gi, ji, ti = (comm.axis_index(a) for a in cfg.axes)
        rank = (gi * r + ji) * c + ti
        pos = st.shard_positions(rank, N, p, "zigzag").to(dev)
        o, res = st.startrail_forward(q[:, pos].contiguous(),
                                      k[:, pos].contiguous(),
                                      v[:, pos].contiguous(), cfg, comm)
        grads = st.startrail_backward(res, o, do[:, pos].contiguous(), cfg,
                                      comm)
        return pos, o, grads

    counts = reset_counts()
    t0 = time.perf_counter()
    res = mesh.run(rank_fn, timeout=300)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts(counts)
    out = torch.empty_like(q)
    grads = [torch.empty(t.shape, device=dev) for t in (q, k, v)]
    for pos, o, gs in res:
        out[:, pos] = o
        for full, gr in zip(grads, gs):
            full[:, pos] = gr
    want = ref.mha_reference(q, k, v, causal=True, window=window)
    # both outputs are rounded to bf16 once: allow a bf16 ulp (2^-7
    # relative) twice over, plus 1e-3 absolute near zero
    diff = (out.float() - want.float()).abs()
    lim = 1e-3 + (want.float().abs() / 64)
    err = float(diff.max())
    check(bool((diff <= lim).all()), f"ring: max err {err} beyond bf16 tol")
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    o_ref = ref.mha_reference(*leaves, causal=True, window=window)
    want_g = torch.autograd.grad(o_ref, leaves, do.float())
    del o_ref, leaves
    grad_err = {}
    for name, a, b in zip(("dq", "dk", "dv"), grads, want_g):
        grad_err[name] = float((a - b).abs().max() / b.abs().max())
        check(bool(torch.isfinite(a).all())
              and grad_err[name] <= RING_GRAD_TOL,
              f"ring {name}: max err / max |ref| {grad_err[name]} beyond "
              f"{RING_GRAD_TOL}")
    check(launches == {"B1": 0, "B2": p * r, "B3": p * r, "B4": 0},
          f"ring launches {launches}: want B2 {p * r} and B3 {p * r} (every "
          f"ring step of every rank) and nothing else")
    emit("ring", c=c, r=r, P=p, N=N, window=window, dtype="bfloat16",
         max_abs_err=err, tol="1e-3 + |ref|/64",
         grad_err_over_max=grad_err, grad_tol=RING_GRAD_TOL,
         launches=launches, seconds=seconds)
    return launches


# ---------------------------------------------------------------------------
# phase 5: the engine at full width
# ---------------------------------------------------------------------------

def reset_counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode as pd

    fa.reset_launches()
    pd.reset_launches()
    return (fa.LAUNCHES, pd.LAUNCHES)


def read_counts(counts):
    out = {}
    for c in counts:
        out.update(c)
    return dict(out)


def phase_engine(dev, smi):
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.engine import Engine, EngineConfig, Request
    from repro_torch.models.factory import build_model
    from repro_torch.plan import make_serve_plan

    cfg = registry.get(ARCH)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng_cfg = EngineConfig(pages_per_shard=512)
    plan_kw = dict(arch=cfg.name, c=1, decode_batch=4, page_size=16,
                   max_len=2048)
    engine = Engine(model, make_serve_plan(cfg, **plan_kw), eng_cfg)
    rng = np.random.default_rng(0)
    # warm-up (cuBLAS handles, allocator), then a clean run
    engine.add_request(Request("warm", rng.integers(0, cfg.vocab_size,
                                                    64).tolist(), 4))
    engine.run()
    engine.reset()
    torch.cuda.reset_peak_memory_stats()
    plens = [64, 200, 336, 472, 608, 744, 880, 1024]
    reqs = [Request(f"req{i}", rng.integers(0, cfg.vocab_size, n).tolist(),
                    32) for i, n in enumerate(plens)]
    counts = reset_counts()
    t0 = time.perf_counter()
    for r in reqs:
        check(engine.add_request(r) is None, f"{r.uid} rejected")
    out = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counts)
    m = engine.metrics
    for r in reqs:
        toks = out.get(r.uid, [])
        check(len(toks) == 32 and all(0 <= t < cfg.vocab_size for t in toks),
              f"{r.uid}: {len(toks)} tokens, want 32 in-vocab")
    L = cfg.num_layers
    # one card: C = R = 1, so each layer's StarTrail forward is one ring
    # step through B2 (merging into the empty accumulator)
    want = {"B1": 0, "B2": L * m.prefills, "B3": 0,
            "B4": L * m.decode_steps}
    check(launches == want, f"engine launches {launches}: want {want} "
          f"({m.prefills} prefills, {m.decode_steps} decode steps)")
    emit("engine", model=cfg.name, params=model.param_count(),
         weights="seeded random bf16", init_s=init_s, requests=len(reqs),
         prompt_lens=plens, new_tokens=32, launches=launches,
         prefills=m.prefills, decode_steps=m.decode_steps,
         ttft_s={r.uid: engine.ttft_s[r.uid] for r in reqs},
         mean_decode_step_ms=1e3 * m.decode_wall_s / max(m.decode_steps, 1),
         prefill_s=m.prefill_wall_s, wall_s=wall,
         tokens_per_s=m.tokens_out / wall,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         card=smi)
    return engine, reqs[5].tokens, launches


def next_token(engine, prompt, rt=None):
    """(hidden state, logits) of ``prompt``'s next token, both f32."""
    import torch

    from repro_torch.engine import sampling

    last, _ = engine.prefill_hidden(prompt, rt=rt)
    with torch.no_grad():
        logits, _ = sampling.shard_logits(engine.rt, engine.model.head, last,
                                          engine.cfg)
    return last.float(), logits


def compare(got, want, what):
    """Relative L2 error and largest error over the largest magnitude of
    the hidden state and the logits, checked against ``ENGINE_TOL``."""
    import torch

    errs = {}
    for i, name in enumerate(("hidden", "logits")):
        a, b = got[i], want[i]
        errs[name] = {"rel_l2": float((a - b).norm() / b.norm()),
                      "max_abs_over_max": float((a - b).abs().max()
                                                / b.abs().max())}
        check(bool(torch.isfinite(a).all())
              and all(errs[name][k] <= ENGINE_TOL[k] for k in ENGINE_TOL),
              f"{what} {name}: {errs[name]} beyond {ENGINE_TOL}")
    return errs


# bf16 keeps 8 significant bits (2^-8 ~ 4e-3 relative per rounding). Two
# routes round each layer's attention output from f32 sums taken in another
# order; a rounding that flips travels down the 24 layers' residual stream.
# Allow 2e-2 relative in the L2 norm (about five roundings' worth) and 5e-2
# of the largest magnitude for the single worst element. These checks catch
# a wrong kernel on the engine's path; the kernels' own precision is held to
# 1e-4 in phase 3.
ENGINE_TOL = {"rel_l2": 2e-2, "max_abs_over_max": 5e-2}


def phase_engine_check(engine, prompt):
    """The CUDA kernels against the plain versions, same weights and card."""
    import dataclasses

    from repro_torch.engine import Engine

    ref_engine = Engine(engine.model, dataclasses.replace(
        engine.plan, kernel_impl="ref", block_impl="ref"), engine.eng)
    got = next_token(engine, prompt)
    want = next_token(ref_engine, prompt)
    errs = compare(got, want, "engine cuda vs ref")
    emit("engine_check", prompt_len=len(prompt), err=errs, tol=ENGINE_TOL,
         argmax_equal=bool(got[1].argmax() == want[1].argmax()))
    return got


def phase_local(engine, prompt, startrail_route):
    """The local-mode prefill (B1 per layer) against the engine's StarTrail
    prefill (B2 per layer) of the same prompt."""
    import dataclasses

    import torch

    rt = dataclasses.replace(engine.rt, attention_impl="local")
    counts = reset_counts()
    got = next_token(engine, prompt, rt=rt)
    torch.cuda.synchronize()
    launches = read_counts(counts)
    L = engine.cfg.num_layers
    check(launches == {"B1": L, "B2": 0, "B3": 0, "B4": 0},
          f"local prefill launches {launches}: want B1 {L} and nothing else")
    errs = compare(got, startrail_route, "local vs StarTrail prefill")
    emit("local", prompt_len=len(prompt), launches=launches, err=errs,
         tol=ENGINE_TOL,
         argmax_equal=bool(got[1].argmax() == startrail_route[1].argmax()))
    return launches


def _profile_window(prof, steps, wall_s, top=12):
    import collections

    import torch

    per_name = collections.defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            rec = per_name[evt.name]
            rec[0] += evt.time_range.elapsed_us() / 1e3
            rec[1] += 1
    check(bool(per_name), "torch.profiler recorded no device activity")
    device_ms = sum(v[0] for v in per_name.values())
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "steps": steps,
        "wall_ms_per_step": 1e3 * wall_s / steps,
        "device_ms_per_step": device_ms / steps,
        "idle_share": 1.0 - device_ms / (1e3 * wall_s),
        "kernel_launches_per_step": sum(v[1] for v in per_name.values())
        / steps,
        "top_kernels": [{"name": n[:90], "ms_per_step": v[0] / steps,
                         "calls_per_step": v[1] / steps}
                        for n, v in ranked],
    }


def phase_profile(engine, smi, prompt_len=1024, decode_steps=8):
    """Where the engine's time goes: ``torch.profiler`` over the last
    admission's prefill plus one decode step with the other slots busy,
    then over ``decode_steps`` decode steps with every slot active."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine import Request

    engine.reset()
    rng = np.random.default_rng(2)
    slots = engine.eng.max_slots

    def request(uid):
        return Request(uid, rng.integers(0, engine.cfg.vocab_size,
                                         prompt_len).tolist(),
                       decode_steps + 4)

    for i in range(slots - 1):
        engine.add_request(request(f"p{i}"))
    engine.step()                           # admits all but the last slot
    engine.add_request(request("last"))
    act = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    windows = (("prefill_and_decode_step", 1), ("decode", decode_steps))
    for name, steps in windows:
        with profile(activities=act) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                engine.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        emit("profile", window=name, prompt_len=prompt_len, slots=slots,
             card=smi, **_profile_window(prof, steps, wall))
    engine.run()


def serving_phases(dev, smi):
    """Phases 5-8 on one engine; returns the engine's and the local
    prefill's launch counts (the engine and its model are freed after)."""
    engine, prompt, engine_launches = phase_engine(dev, smi)
    startrail_route = phase_engine_check(engine, prompt)
    local_launches = phase_local(engine, prompt, startrail_route)
    phase_profile(engine, smi)
    return engine_launches, local_launches


# ---------------------------------------------------------------------------
# phases 9-11: training at the full width
# ---------------------------------------------------------------------------

TRAIN_SEQ, TRAIN_STEPS = 4096, 6
TRAIN_RECKONED_BYTES = 40e9   # bf16 params + grads, f32 moments, activations


class RepeatBatch:
    """A data source that serves one batch at every step: a loss that falls
    over a few steps shows the model learns (memorises) it."""

    def __init__(self, source):
        self.batch = source.get_batch(0)

    def get_batch(self, step):
        return self.batch


def _train_shape(seq):
    from repro_torch.configs.base import ShapeConfig

    return ShapeConfig(f"train_{seq // 1024}k_b1", seq, 1, "train")


def phase_train(dev, smi):
    import math
    import tempfile

    import torch

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.factory import build_model
    from repro_torch.optim import adamw
    from repro_torch.plan import make_plan
    from repro_torch.train import trainer

    cfg = registry.get(ARCH)
    shape = _train_shape(TRAIN_SEQ)
    plan = make_plan(cfg, shape, arch=ARCH, c=1)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    adam = adamw.AdamWConfig(learning_rate=1e-3, warmup_steps=0,
                             state_dtype=cfg.opt_dtype)
    data = RepeatBatch(SyntheticLM(cfg, shape, seed=0,
                                   seq_scheme=plan.seq_scheme,
                                   sp_size=plan.sp_size))
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train_metrics.jsonl")
        counts = reset_counts()
        t0 = time.perf_counter()
        trainer.train(model, plan, adam, trainer.TrainerConfig(
            num_steps=TRAIN_STEPS, log_every=TRAIN_STEPS, metrics_path=path),
            data_source=data, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(counts)
        with open(path) as f:
            recs = [json.loads(line) for line in f]
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in recs]
    check(len(recs) == TRAIN_STEPS and all(math.isfinite(x) for x in losses),
          f"train losses {losses}: want {TRAIN_STEPS} finite")
    check(losses[-1] < losses[0],
          f"train loss did not fall over one repeated batch: {losses}")
    L = cfg.num_layers
    want = {"B1": 0, "B2": L * TRAIN_STEPS, "B3": L * TRAIN_STEPS, "B4": 0}
    check(launches == want, f"train launches {launches}: want {want} (one "
          f"ring step forward and backward per layer and step)")
    step_ms = [1e3 * r["step_s"] for r in recs]
    # step_s of step i is its dispatch plus the wait on step i-1; from the
    # third step on it is the steady device step
    steady = statistics.median(step_ms[2:])
    emit("train", model=cfg.name, params=model.param_count(),
         weights="seeded random bf16", init_s=init_s,
         shape={"seq_len": shape.seq_len, "batch": shape.global_batch},
         plan={"P_sp": plan.sp_size, "C": plan.c, "R": plan.r,
               "seq_scheme": plan.seq_scheme, "block_impl": plan.block_impl,
               "remat": plan.remat},
         adamw={"lr": adam.learning_rate, "warmup": adam.warmup_steps,
                "state_dtype": adam.state_dtype},
         losses=losses, grad_norm=[r["grad_norm"] for r in recs],
         step_ms=step_ms, steady_step_ms=steady,
         tokens_per_s=shape.seq_len * shape.global_batch / (steady / 1e3),
         wall_s=wall, max_memory_allocated=peak,
         reckoned_bytes=TRAIN_RECKONED_BYTES, launches=launches, card=smi)
    return model, launches


# The CUDA kernels against the plain versions through a whole model at seq
# 1024: bf16 activations round differently once the attention sums are
# taken in another order, and a flip travels down the 24 layers, so each
# gradient leaf is held to 5e-2 relative in the L2 norm and the loss to
# 2e-3 relative. These catch a wrong kernel on the training path; the
# kernels' own precision is held to 3e-4 in phase 3.
TRAIN_CHECK_TOL = {"loss_rel": 2e-3, "grad_rel_l2": 5e-2}


def phase_train_check(model, dev):
    import math

    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train import step as train_step

    shape = _train_shape(1024)
    batch = train_step.to_device(
        SyntheticLM(model.cfg, shape, seed=1).get_batch(0), dev)
    out = {}
    for impl in ("cuda", "ref"):
        vg_fn, _ = train_step.build_value_and_grad_fn(
            model, RunConfig(block_impl=impl), shape)
        out[impl] = vg_fn(batch)
    (loss_c, g_c), (loss_r, g_r) = out["cuda"], out["ref"]
    loss_rel = abs(float(loss_c) - float(loss_r)) / abs(float(loss_r))
    names = [n for n, _ in model.named_parameters()]
    rel = {n: float((a.float() - b.float()).norm() / b.float().norm())
           for n, a, b in zip(names, g_c, g_r)}
    worst = max(rel, key=rel.get)
    check(all(math.isfinite(x) for x in rel.values())
          and loss_rel <= TRAIN_CHECK_TOL["loss_rel"]
          and rel[worst] <= TRAIN_CHECK_TOL["grad_rel_l2"],
          f"train_check: loss rel {loss_rel}, worst grad leaf {worst} rel "
          f"L2 {rel[worst]}, beyond {TRAIN_CHECK_TOL}")
    emit("train_check", seq_len=shape.seq_len, batch=1,
         loss={"cuda": float(loss_c), "ref": float(loss_r)},
         loss_rel=loss_rel, loss_rel_tol=TRAIN_CHECK_TOL["loss_rel"],
         grad_rel_l2_worst={"leaf": worst, "value": rel[worst]},
         grad_rel_l2_median=statistics.median(rel.values()),
         grad_rel_l2_tol=TRAIN_CHECK_TOL["grad_rel_l2"], leaves=len(rel))


def phase_train_profile(model, dev, smi):
    """Where a train step's time goes: ``torch.profiler`` over one
    full-width step (the card is warm from phase 9)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.plan import make_plan
    from repro_torch.train import step as train_step

    shape = _train_shape(TRAIN_SEQ)
    plan = make_plan(model.cfg, shape, arch=ARCH, c=1)
    adam = adamw.AdamWConfig(learning_rate=1e-3, warmup_steps=0)
    step_fn, sh = plan.build_train_step(model, adam)
    opt = adamw.init_state(sh["params"], adam)
    batch = train_step.to_device(
        SyntheticLM(model.cfg, shape, seed=0).get_batch(0), dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    emit("train_profile", seq_len=shape.seq_len, batch=1, card=smi,
         **_profile_window(prof, 1, wall, top=15))


def free_device():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def main():
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 3
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script "
              f"(src/repro_torch): {e}", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    try:
        smi = nvidia_smi()
        emit("device", name=torch.cuda.get_device_name(0),
             count=torch.cuda.device_count(), nvidia_smi=smi,
             torch=torch.__version__, cuda=torch.version.cuda)
        info = _build.build_info()
        emit("build", seconds=info["seconds"], built=info["built"],
             ptxas=info["ptxas"])
        rows = phase_kernels(dev)
        free_device()
        by_path = {"ring": phase_ring(dev)}
        by_path["engine"], by_path["local"] = serving_phases(dev, smi)
        free_device()
        model, by_path["train"] = phase_train(dev, smi)
        free_device()
        phase_train_check(model, dev)
        free_device()
        phase_train_profile(model, dev, smi)
        paths = {"B1": "local", "B2": "engine", "B3": "train",
                 "B4": "engine"}
        for name, row in rows.items():
            row["launches"] = by_path[paths[name]][name]
            row["launches_by_path"] = {k: v[name] for k, v in by_path.items()}
            check(row["launches"] > 0, f"{name} never launched on its path")
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        return 1
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "tol", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(f"seconds {time.perf_counter() - t_start:.1f}", flush=True)
    print(smi)
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
