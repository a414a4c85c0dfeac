#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (``{"phase": ...}``):

  1. device   the card's name and ``nvidia-smi`` name / power limit
  2. build    nvcc of ``src/repro_torch/csrc/*.cu`` for sm_90a: seconds and
              the ``-Xptxas -v`` register / shared-memory / spill summary
  3. kernels  each CUDA kernel against its plain PyTorch version on the card
              (B1, B2, B3 at the 1024-token shapes, B2 and B3 again at the
              training shape, seq 4096, B3 and B2 on one 12288-token block
              of 4 query heads over one kv head, B4 at a decode step, B5 on
              ragged rows and the legacy decode shape, B6 on a 256-query chunk
              after cached prefixes, B4 and B6 also on one rank's shard at
              SP degree 2 and 8, B7 on ragged rows with offsets and a
              zero-length row, rectangular MQA, a window over 1000 rows and
              the ragged_bwd path's shape), and timed (``ms``: CUDA
              events, median of bursts after warm-up; ``device_ms``: calls
              queued behind a device sleep, which the host's pace cannot
              stretch) beside the plain version, a PyTorch library call
              where one computes the same function, and the card's bound
              for the work: B1, B2, B4, B5 and B6 at the serving shapes,
              B3 (and B2 again) at the training shape, B7 at the
              ragged_bwd path's shape; B1 beside two SDPA calls (a
              boolean mask, and is_causal with enable_gqa), B2 at seq 4096
              beside SDPA's forward (o only, no merge), B3 and B7 beside
              SDPA's backward, B4 and B6 beside references (SDPA on their
              keys gathered densely beforehand); B3, B4, B6 and B7 run
              twice on every check and must give the same bits; CTAs per
              SM and shared memory of the bf16 forward and backward
              kernels
  3a. kernels_ulysses  B1 and B3 at the shape Ulysses gives them (q
              (1,4096,4,80) over one kv head, the 8 zigzag shards
              concatenated, and sorted), bf16 and f32 against their plain
              versions; ``device_ms`` and bound of each on bf16
  3b. kernels_d128  every kernel at head size 128 (GPT-7B, minitron-8b,
              deepseek-7b): phase 3's check cases again at D = 128, bf16
              and f32 (among them B4 and B6 on one rank's 64-page shard at
              SP degree 8, the shapes dense_serve's P = 8 runs give them:
              4 decode slots at rank 5, and q (1,256,32,128) after a
              512-token prefix at rank 3), then B1, B2 and B3 at GPT-7B's
              training shape (q,
              k, v (1,4096,32,128), causal), B4 at minitron-8b's decode
              step (4 slots at ~1K context, 32q/8kv, pages of 16), B6 at
              its 256-query chunk after a 1024-token prefix, B5 at the
              legacy decode shape and B7 at the ragged_bwd shape, each
              held against its plain version at the same tolerances and
              timed beside its bound and SDPA where one computes the
              function; the ``-Xptxas -v`` lines of the D = 128 kernels
  4. ring     StarTrail on a ThreadMesh(c=2, r=2): P = 8 ranks as threads
              on the one card, N = 2048 tokens of 32q/8kv heads of 80,
              bf16, causal + window; each rank runs the forward (B2 in
              every ring step) and then the backward (B3 in every ring
              step) explicitly; o and the gradients are held against plain
              full attention of the sequence and its autograd gradients
  4a. ragged_bwd  the kernel layer's public entries with per-row (B, S)
              positions: ``dispatch.block_fwd`` (B5), then
              ``dispatch.block_bwd`` (B7), on 4 rows of 1024 tokens at
              different offsets, 32q/8kv heads of 80, bf16, causal, window
              4096; the gradients are held against autograd through the
              plain version
  5. engine   the serving engine at the full width of h2o-danube-1.8b
              (24 layers, seeded random bf16 weights): 8 greedy requests,
              prompts staggered over 64-1024 tokens, 32 new tokens each.
              Each prefill runs StarTrail at P = 1, one ring step per layer
              through B2; each decode step runs B4 once per layer; 4 pure
              decode steps profiled (the all-greedy window), which the
              mean decode step and tokens/s leave out
  5a. sample  sampled decoding on the same model and plan: the engine
              phase's 8 prompts and budgets, even requests greedy, odd ones
              at temperature 0.9 with top-k 0/16/32 and top-p 1.0/0.9/0.8
              in turn, seeds 100 + i, through an engine with an
              ``obs.Registry`` and an enabled ``Tracer``. The greedy
              streams must equal the engine phase's (another batch) and
              every sampled stream its request served alone; the dumped
              registry's token, TTFT and inter-token counts and the trace's
              request b/e pairs and ``engine/step`` spans must match the
              run. Beside: 4 profiled pure decode steps (the mixed window,
              the same steps as the engine phase's), the solo runs' decode
              steps with the tracer on against ``NULL_TRACER`` on alternate
              steps, ``latency_quantiles()``; ``sample`` on CUDA tensors at V = 32000, 4 rows, 4096 draws
              at temperature 1 (top-k 8: every draw in the top 8, the
              chi-square of the counts against the softmax over them below
              24.3, the 0.999 quantile at 7 degrees of freedom; top-p 0.4:
              every draw in the nucleus); ``launch.serve --smoke --kernel
              ref`` on the card with ``--temperature --top-k --top-p
              --metrics-dump --trace-out``
  6. engine_check  one prompt's next-token hidden state and logits under
              the CUDA kernels against the same engine on the plain versions
  7. local    the same prompt's prefill under the local-mode attention
              (``Runtime(attention_impl='local')``: one block per layer
              through B1), held against the engine's StarTrail prefill
  8. profile  ``torch.profiler`` over the engine with 4 slots of 1024-token
              prompts: one prefill plus decode step, then 8 decode steps;
              host and device ms per step, device idle share, top kernels
  8a. prefix  the engine with the prefix cache and 256-token prefill
              chunks: 8 greedy requests sharing a 1024-token prefix, each
              with its own 64-512-token suffix, 32 new tokens each. A
              prompt's first chunk runs B2 per layer; every later chunk and
              every prefix hit runs B6 (the cached pages) and B1 (the
              chunk itself) per layer. Each request's first token and
              next-token hidden state are held against a monolithic prefill
              of its prompt; then TTFT of one request alone with the prefix
              cached and without the cache
  8b. legacy  the static-batch path (``launch.serve.legacy_generate``): 4
              prompts of 1024 tokens prefilled as one batch (B2 per layer),
              then 31 decode steps against the contiguous cache, B5 per
              layer and step; the first decode step's hidden state and
              token are held against the engine's
  9. train    the full-width model trains through ``train.trainer.train``
              with a plan from ``make_plan(c=1, microbatches=4)`` and its
              default recompute (``remat='attn_out'``): seq 4096, global
              batch 4 in 4 microbatches, bf16, AdamW (f32 moments, lr 1e-3,
              no warmup), 4 steps on one repeated ``SyntheticLM`` batch.
              Per layer and microbatch the StarTrail ring step runs forward
              twice (B2: the forward and its recompute) and backward once
              (B3); the loss must be finite and fall
 10. train_check  one loss and gradient of the same model at seq 1024
              under the CUDA kernels against the plain versions
 11. train_profile  ``torch.profiler`` over one full-width train step of
              one sequence under ``remat='none'`` and one under 'attn_out'
 12. resume   checkpoint and restart at full width with the depth cut to 2
              layers: 4 steps straight, and 2 steps with ``ckpt_dir``
              followed by a fresh model resumed from that checkpoint to
              step 4; steps 3-4 must give the same losses
 13. train_sp  training at SP degree 8: ``trainer.train`` on a plan with
              ``n_devices=8, c=2`` runs P = 8 ranks as ThreadMesh(c=2, r=2)
              threads on the one card (team gathers and two ring steps;
              the collectives carry the gradients). Full width with the
              depth cut to 8 layers (P ranks' gradients share one card),
              seq 4096, batch 1, zigzag, ``remat='attn_out'``, bf16, 3
              AdamW steps on one repeated batch: the loss must fall, and
              the first step's loss and gradient norm agree with P = 1 on
              the same weights. Per step B2 runs 8 ranks x 2 ring steps x
              2 (recompute) x 8 layers = 256 times and B3 128 times.
              Before it, in f32 (the CUDA-core kernels), depth 2, seq 1024:
              the loss and every gradient leaf at P = 8 against P = 1
 14. schemes  the paper's comparison at the same size (8 layers, seq 4096,
              batch 1, bf16, ``attn_out``, P = 8 ranks on the card) through
              ``trainer.train`` with the obs registry and tracer, 2 steps
              each from the same weights: the ring (C = 1, R = 8: B2
              8*8*2*L and B3 8*8*L a step), DeepSpeed-Ulysses (all-to-all;
              B1 8*2*L and B3 8*L) and StarTrail C = 2 with each ring
              transfer in 2 sub-chunks (train_sp's counts). Each first
              step's loss and grad norm against P = 1 (``TRAIN_SP_TOL``);
              each scheme's forward island (one layer, full width, seq
              4096) through ``obs.commlog.comm_report``: every live kind
              at ratio 1.0 and no byte of a kind the scheme does not
              run, printed beside eqs. 2-4's bytes; the ledger's bytes per step beside
              ``CommLog.per_step``; a profiled step of the ring and Ulysses
 15. autotune  the paper's §3.4 topology scheduler at the schemes phase's
              size: the analytical ranking of the four arrangements at
              P = 8 under the H100 table (``roofline.hw``; µs per layer,
              whole-model s, bytes), then ``plan.autotune.autotune``
              (top 3 plus the analytical worst, 1 warm-up and 2 timed
              steps each, every candidate from the same weights): each
              candidate's measured s per step beside its analytical s, the
              winner, its plan file reloaded equal and holding the
              arrangement its record timed fastest, one step of
              ``launch.train --plan FILE`` (B2 and B3, or B1 and B3 if
              Ulysses won) and ``make_serve_plan(c=None)`` at P = 1 (C = 1)
 16. dense_serve  the engine at the full width of minitron-8b (32 layers,
              d_model 4096, 32q/8kv heads of 128, vocab 256000, ~9.9 B
              seeded bf16 parameters). At P = 1: 8 greedy requests of
              64-1024 prompt tokens, 32 new tokens each (B2 per layer and
              prefill, B4 per layer and decode step). At P = 8, as
              ThreadMesh(c=2, r=2) threads on the one card from the same
              weights, cut to keep the phase near 150 s (the 8 rank threads
              share the GIL: a step takes seconds): 4 of those prompts
              (336-1024 tokens) with 8 new tokens each (B2 on every rank,
              ring step and layer of a prefill, B4 on every rank and layer
              of a decode step), then 2 prompts sharing a 512-token prefix
              through the prefix cache and 256-token chunks (B6 and B1 on
              every rank and layer of a suffix chunk, merged across the
              ranks). Every first-token hidden state at P = 8 is held
              against P = 1's (``DENSE_SP_TOL``), the share of tokens that
              agree with P = 1's printed; the engine raises if the ranks
              sample different tokens; a profiled decode step at each P.
              Then at P = 8 one sampled request (prompt 4, temperature 0.8,
              top-k 40, top-p 0.9) beside one greedy (prompt 2), 8 new
              tokens each: the sampled stream equals its solo run, the
              greedy one its stream in the all-greedy run
 17. dense_train  ``trainer.train`` on the paper's GPT-7B (MHA 32/32, head
              size 128) at seq 4096, batch 1, bf16, ``attn_out``, 3 AdamW
              steps on one repeated batch at P = 1, the depth cut from 32
              to 8 layers (the reckoned bytes of both printed: weights,
              gradients and f32 moments of 32 layers exceed 80 GB); the
              loss must fall; B2 2 x 8 and B3 8 a step; the D = 128
              backward kernels' device ms from a profiled step; one loss
              and gradient at seq 1024 under the CUDA kernels against the
              plain versions (``dense_train_check``)

The paths are phases 4, 4a, 5, 5a, 7, 8a, 8b, 9, 13, each scheme of 14,
15's search and its plan's step, 16's four runs and 17:
the launch counters are set to 0 just before each and read just after,
and each must launch exactly the kernels it runs (B2 and B3 in the ring;
B5 and B7 in ragged_bwd; B2 and B4 in the engine and in the sample
phase's mixed run; B1 in the local
prefill; B1, B2, B4 and B6 in the prefix phase; B2 and B5 in the legacy
phase; B2 and B3 in the train loop, in train_sp and in the ring and
StarTrail schemes; B1 and B3 under Ulysses; B1, B2 and B3 in the
autotune search, whose candidates are all four arrangements; B2 and B4
in dense_serve's P = 1, P = 8 and P = 8 sampled runs, B1, B2, B4 and B6
in its prefix run; B2 and B3 in dense_train). Comparison,
timing and profiling launches are not counted. The kernels line's
``launches`` is each kernel's count on the path that runs it (the engine for B2 and B4, the local prefill for B1, the train
loop for B3, the legacy phase for B5, the prefix phase for B6, ragged_bwd
for B7); ``launches_by_path`` gives every path's counts. The
last three lines are the card's ``nvidia-smi`` name and power limit, the
kernels' JSON line and ``{"ok": true, "device": {...}}``.
Any failed check exits non-zero before the last line; so does a machine
without a CUDA card, or a directory without the rest of the repository.
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

TOL = {"float32": 2e-5, "bfloat16": 1e-4}       # see phase_kernels
NEG_INF = -1e30
BWD_TOL = 3e-4                                   # see phase_kernels
LONG_BWD_SEQ = 12288                             # B3's long-block check
LONG_FWD_SEQ = 12288                             # B2's long-block check
REPLACES = {
    "B1": "src/repro/kernels/flash_attention.py:125",
    "B2": "src/repro/kernels/flash_attention.py:148",
    "B3": "src/repro/kernels/flash_attention.py:440",
    "B4": "src/repro/kernels/paged_decode.py:48",
    "B5": "src/repro/kernels/ragged_prefill.py:48",
    "B6": "src/repro/kernels/paged_prefill.py:56",
    "B7": "src/repro/kernels/flash_attention.py:537",
}
SOURCES = {"B1": "src/repro_torch/csrc/flash_fwd.cu",
           "B2": "src/repro_torch/csrc/flash_fwd.cu",
           "B3": "src/repro_torch/csrc/flash_bwd.cu",
           "B4": "src/repro_torch/csrc/paged_decode.cu",
           "B5": "src/repro_torch/csrc/ragged_prefill.cu",
           "B6": "src/repro_torch/csrc/paged_prefill.cu",
           "B7": "src/repro_torch/csrc/ragged_bwd.cu"}
KERNELS = tuple(SOURCES)
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


def device_ms(fn, calls=20, reps=5):
    """Per call, median over ``reps``: CUDA events around ``calls`` calls
    queued behind a ~50 ms device sleep, so the host has enqueued them all
    before the first starts and the card runs them back to back. Unlike
    ``time_ms`` it leaves out the host's time when a call is shorter than
    its Python wrapper."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)          # cycles, ~50 ms
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def hw_table():
    """The card's datasheet peaks the bounds use (``roofline.hw``)."""
    from repro_torch.roofline import hw

    return {"source": "NVIDIA H100 80GB HBM3 (SXM5), 700 W, datasheet",
            "PEAK_FLOPS_BF16": hw.PEAK_FLOPS_BF16,
            "PEAK_FLOPS_F32": hw.PEAK_FLOPS_F32, "HBM_BW": hw.HBM_BW,
            "NVLINK_BW": hw.NVLINK_BW}


def bound(nbytes, flops, dtype):
    from repro_torch.roofline import hw

    peak = {"bfloat16": hw.PEAK_FLOPS_BF16, "float32": hw.PEAK_FLOPS_F32}
    t_bytes = nbytes / hw.HBM_BW * 1e3
    t_ops = flops / peak[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def same_bits(got, want):
    """Whether two runs' outputs are equal to the bit."""
    import torch

    return all(bool(torch.equal(a, b)) for a, b in zip(got, want))


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


def fwd_inputs(dtype, dev, seed=0, d=80):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((1, 1024, 32, d), generator=g, device=dev)
    k = torch.randn((1, 1024, 8, d), generator=g, device=dev)
    v = torch.randn((1, 1024, 8, d), generator=g, device=dev)
    o_acc = torch.randn((1, 1024, 32, d), generator=g, device=dev)
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


def bwd_inputs(pos_q, pos_k, window, dtype, dev, seed=0, heads=(32, 8),
               d=80):
    """q, k, v, do in ``dtype`` and the global lse and delta of full
    attention over the block (delta from o rounded to q's dtype, as
    ``core.startrail.startrail_backward`` computes it)."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(seed)
    sq, sk = pos_q.numel(), pos_k.numel()
    hq, hkv = heads
    q = torch.randn((1, sq, hq, d), generator=g, device=dev).to(dtype)
    k = torch.randn((1, sk, hkv, d), generator=g, device=dev).to(dtype)
    v = torch.randn((1, sk, hkv, d), generator=g, device=dev).to(dtype)
    do = torch.randn((1, sq, hq, d), generator=g, device=dev).to(dtype)
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


def scaled_err(got, want):
    """max |g - g_ref| / (1 + |g_ref|) over dq, dk, dv: what ``grad_err``'s
    tolerance check bounds by ``tol``."""
    return max(float(((a - b).abs() / (1 + b.abs())).max())
               for a, b in zip(got, want))


def bwd_work(q, k, pos_q, pos_k, pairs):
    """(bytes, flops) of B3 / B7: q, k, v, do, lse, delta and the positions
    in once, dq, dk, dv out in f32; 10*D FLOPs per visible pair and query
    head (the recomputed scores, dp, dq, dk, dv)."""
    b, sq, hq, d = q.shape
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() \
        + 2 * b * hq * sq * 4 + (pos_q.numel() + pos_k.numel()) * 4 \
        + (q.numel() + 2 * k.numel()) * 4
    return nbytes, 10 * d * hq * pairs


def sdpa_bwd_ms(q, k, v, do, mask=None):
    """(event ms, device ms) of the autograd backward alone of
    ``scaled_dot_product_attention`` on the same inputs: causal with GQA
    (the library yardstick of B3), or with the boolean ``mask``
    (B,1,Sq,Sk) and the kv heads repeated beforehand (B7's)."""
    import torch
    import torch.nn.functional as F

    g = q.shape[2] // k.shape[2]
    if mask is not None:
        k, v = (t.repeat_interleave(g, dim=2) for t in (k, v))
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    if mask is None:
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
    else:
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    dot = do.transpose(1, 2)

    def fn():
        return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

    return time_ms(fn, reps=10, inner=2), device_ms(fn, calls=5)


def paged_sdpa(q, pool_k, pool_v, table, lens, ps, window, decode):
    """A reference for B4 (``decode``) and B6, not their function: a
    callable running ``scaled_dot_product_attention`` (o only, no lse) on
    the keys of the table's allocated pages, gathered densely here, before
    any timing, with kv heads repeated and the boolean mask of the kernel's
    key validity and window (no mask when every pair is visible). SP
    degree 1."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref

    b, sq, hq, _ = q.shape
    n = int((table >= 0).any(0).nonzero().max()) + 1
    tb = table[:, :n].long()
    k, v = (p[tb.clamp(min=0)].reshape(b, n * ps, *p.shape[2:])
            for p in (pool_k, pool_v))
    dev = q.device
    pos = torch.arange(n * ps, dtype=torch.int32, device=dev)
    valid = (tb >= 0).repeat_interleave(ps, 1) & \
        (pos[None] < (lens + int(decode))[:, None])
    pos_q = lens[:, None] + torch.arange(sq, dtype=torch.int32,
                                         device=dev)[None]
    pos_k = torch.where(valid, pos[None], pos_q.max() + 1)
    mask = ref.make_mask(pos_q, pos_k, causal=True, window=window)[:, None]
    g = hq // k.shape[2]
    qt = q.transpose(1, 2)
    kt, vt = (t.transpose(1, 2).repeat_interleave(g, dim=1) for t in (k, v))
    mask = None if bool(mask.all()) else mask
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)


def paged_cases():
    # name: (sp, rank, window, cache_len per row (row 3 inactive))
    return {
        "sp1": (1, 0, None, [1023, 520, 7, 0]),
        "sp1_window256": (1, 0, 256, [1023, 700, 300, 0]),
        "sp2_rank1": (2, 1, 4096, [2047, 1000, 40, 0]),
        "decode_1k": (1, 0, 4096, [1023, 1010, 1000, 990]),
        # dense_serve's P = 8 decode step: one rank's 64-page shard
        "sp8_rank5": (8, 5, None, [1031, 700, 300, 0]),
    }


def paged_inputs(dev, sp, cache_len, seed=0, dtype=None, d=80, rank=None):
    """q (4,1,32,d); pool (512/sp,16,8,d) (bf16 unless ``dtype``), rank
    ``rank``'s shard (default 1 when sp > 1) of a 512-page cache as the
    engine splits it; table (4, min(64, 128/sp)): distinct pages for the
    rank's blocks (global block w*sp + rank at entry w) each row has
    written, -1 past them, so the last page of a row is partial; a row with
    cache_len 0 is an inactive slot."""
    import numpy as np
    import torch

    dtype = dtype or torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed)
    pages, width = 512 // sp, min(64, 128 // sp)
    q = torch.randn((4, 1, 32, d), generator=g, device=dev).to(dtype)
    pool_k = torch.randn((pages, 16, 8, d), generator=g, device=dev).to(dtype)
    pool_v = torch.randn((pages, 16, 8, d), generator=g, device=dev).to(dtype)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(pages)
    table = np.full((4, width), -1, np.int32)
    used = 0
    if rank is None:
        rank = 1 if sp > 1 else 0
    for b, cl in enumerate(cache_len):
        if cl == 0:
            continue
        blocks = cl // 16 + 1           # global blocks 0 .. cl // 16
        n_local = min(width, (blocks - rank + sp - 1) // sp)
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


def ragged_cases():
    # name: (Sq, Sk, window, per-row lengths or cache lengths, kind)
    return {
        # prefill rows of 256, 130, 0 (sees no key) and 77 keys
        "ragged_rows": (256, 256, 4096, [256, 130, 0, 77], "lengths"),
        # the legacy decode shape: one query per row at its cache length
        "decode_sq1": (1, 1056, 4096, [1024, 1030, 1041, 1055], "decode"),
        "decode_window256": (1, 1056, 256, [1024, 700, 300, 5], "decode"),
    }


def ragged_inputs(dev, dtype, sq, sk, rows, kind, seed=0, d=80):
    """q (B,Sq,32,d), k/v (B,Sk,8,d) and per-row positions: validity is
    positional, an unseen key sits past every query."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    b = len(rows)
    q = torch.randn((b, sq, 32, d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, sk, 8, d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, sk, 8, d), generator=g, device=dev).to(dtype)
    ak = torch.arange(sk, dtype=torch.int32, device=dev)[None]
    r = torch.tensor(rows, dtype=torch.int32, device=dev)[:, None]
    if kind == "lengths":
        pos_q = torch.arange(sq, dtype=torch.int32, device=dev)[None]
        pos_q = pos_q.expand(b, sq)
        pos_k = torch.where(ak < r, ak, sq + sk)
    else:
        pos_q = r
        pos_k = torch.where(ak <= r, ak, r + 1)
    return (q, k, v), pos_q.contiguous(), pos_k.contiguous()


def ragged_work(q, k, pos_q, pos_k, window):
    """(bytes, flops) of B5 on these inputs: q, the keys some query sees
    (K and V), the positions in once, o and lse out in f32; 4*D FLOPs per
    visible pair and query head."""
    from repro_torch.kernels import ref

    mask = ref.make_mask(pos_q, pos_k, causal=True, window=window)
    b, sq, hq, d = q.shape
    keys = int(mask.any(dim=1).sum())
    nbytes = q.numel() * q.element_size() \
        + 2 * keys * k.shape[2] * d * k.element_size() \
        + (pos_q.numel() + pos_k.numel()) * 4 + b * sq * hq * d * 4 \
        + b * hq * sq * 4
    return nbytes, 4 * d * hq * int(mask.sum())


def paged_prefill_cases():
    # name: (cached_len per row, window, unallocated table entries of row 0,
    #        sp, rank)
    return {
        # row 0's last cached page is half filled; row 1 has nothing cached
        "partial_page_and_empty": ([1000, 0], 4096, [], 1, 0),
        "unallocated": ([1024], 4096, [5, 40], 1, 0),
        # queries 1024..1279 in a window of 256: the later ones see no key
        "window_slid": ([1024], 256, [], 1, 0),
        "prefix_1024": ([1024], 4096, [], 1, 0),  # the prefix phase's shape
        # dense_serve's P = 8 suffix chunk after its 512-token prefix: one
        # rank's 64-page shard, its blocks at w*8 + 3
        "sp8_rank3_prefix512": ([512], None, [], 8, 3),
    }


def paged_prefill_inputs(dev, dtype, cached, holes, sq=256, seed=0, d=80,
                         sp=1, rank=0):
    """q (B,256,32,d); pool (512/sp,16,8,d), rank ``rank``'s shard of a
    512-page cache as the engine splits it; table (B,128/sp): distinct
    pages for the rank's blocks (global block w*sp + rank at entry w) of
    each row's prefix and suffix, -1 past them and at ``holes`` in row 0."""
    import numpy as np
    import torch

    pages, width = 512 // sp, 128 // sp
    g = torch.Generator(device=dev).manual_seed(seed)
    b = len(cached)
    q = torch.randn((b, sq, 32, d), generator=g, device=dev).to(dtype)
    pool_k = torch.randn((pages, 16, 8, d), generator=g, device=dev).to(dtype)
    pool_v = torch.randn((pages, 16, 8, d), generator=g, device=dev).to(dtype)
    perm = np.random.default_rng(seed).permutation(pages)
    table = np.full((b, width), -1, np.int32)
    used = 0
    for row, cl in enumerate(cached):
        blocks = -(-(cl + sq) // 16)
        n_local = max(0, -(-(blocks - rank) // sp))
        table[row, :n_local] = perm[used:used + n_local]
        used += n_local
    table[0, holes] = -1
    return (q, pool_k, pool_v, torch.from_numpy(table).to(dev),
            torch.tensor(cached, dtype=torch.int32, device=dev))


def paged_prefill_work(table, cached, sq, window, ps=16, hkv=8, d=80,
                       hq=32, sp=1, rank=0):
    """(bytes, flops) this data needs: q in, the K and V of the pages some
    query sees, the table and lengths, o and lse out in f32; 4*D FLOPs per
    visible (query, key) pair and query head; no window is ``window=None``."""
    window = (1 << 30) if window is None else window
    pages = pairs = 0
    for b, cl in enumerate(cached):
        for w in range(table.shape[1]):
            base = (w * sp + rank) * ps
            if table[b, w] < 0 or base >= cl:
                continue
            # query i (position cl + i) sees key p iff cl + i - p < window
            n = sum(min(sq, max(0, window - cl + p))
                    for p in range(base, min(base + ps, cl)))
            pages += n > 0
            pairs += n
    rows = len(cached)
    io = (rows * sq * hq * d * 2 + table.size * 4 + rows * 4
          + rows * sq * hq * d * 4 + rows * hq * sq * 4)
    return 2 * pages * ps * hkv * d * 2 + io, 4 * d * hq * pairs


def ragged_bwd_cases():
    # name: (B, Sq, Sk, Hq, Hkv, window, row offsets, zero-length rows)
    return {
        # rows at their own offsets; row 2's keys all sit past its queries
        "ragged_rows": (4, 256, 256, 32, 8, 4096, [0, 300, 77, 1000], [2]),
        "mqa_rect": (2, 192, 320, 8, 1, 4096, [0, 50], []),
        # 1000 rows: not a multiple of the 64-row tile
        "window256_s1000": (2, 1000, 1000, 32, 8, 256, [0, 17], []),
        # the ragged_bwd path's shape
        "path_4x1024": (4, 1024, 1024, 32, 8, 4096, [0, 1024, 2048, 3072],
                        []),
    }


def ragged_bwd_inputs(dev, dtype, b, sq, sk, hq, hkv, window, offsets,
                      zero_rows, seed=0, d=80):
    """q, k, v, do in ``dtype``, the global lse and delta of the block pair
    (delta from o rounded to q's dtype), and (B,Sq) / (B,Sk) positions: row
    r's queries start at ``offsets[r]`` and its keys end with them (an Sk >
    Sq row sees keys before its first query); the keys of ``zero_rows`` sit
    past every query."""
    import torch

    from repro_torch.kernels import ragged_prefill as rp

    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, sq, hq, d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, sk, hkv, d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, sk, hkv, d), generator=g, device=dev).to(dtype)
    do = torch.randn((b, sq, hq, d), generator=g, device=dev).to(dtype)
    off = torch.tensor(offsets, dtype=torch.int32, device=dev)[:, None]
    pos_q = off + torch.arange(sq, dtype=torch.int32, device=dev)[None]
    pos_k = off + torch.arange(sk, dtype=torch.int32, device=dev)[None] \
        + (sq - sk)
    pos_k[zero_rows] += 2 * (sq + sk)
    o, lse = rp.ragged_prefill_fwd_plain(q, k, v, pos_q, pos_k,
                                         window=window)
    delta = torch.einsum("bshd,bshd->bhs", do.float(),
                         o.to(dtype).float()).contiguous()
    return (q, k, v, do, lse, delta, pos_q.contiguous(),
            pos_k.contiguous())


def check_cases(dev, rows, d=80):
    """Every kernel against its plain version on the check cases above,
    bf16 and f32, at head size ``d``: each row's ``max_abs_err`` (and B3's
    and B7's ``max_scaled_err``) rises to the worst case. Returns the
    cases checked."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.kernels import ragged_bwd as rb
    from repro_torch.kernels import ragged_prefill as rp

    checked = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        (q, k, v), o_acc, lse_acc = fwd_inputs(dtype, dev, d=d)
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
            args = bwd_inputs(pq, pk, window, dtype, dev, d=d)
            got = fa.flash_attention_bwd(*args, pq, pk, window=window)
            torch.cuda.synchronize()
            want = fa.flash_attention_bwd_plain(*args, pq, pk, window=window)
            err, ok, n_dead = grad_err(got, want, args[4], BWD_TOL)
            check(ok, f"B3 {case} {dname}: max err {err} (tol {BWD_TOL}) "
                      f"or a dead row's dq not exactly 0")
            if case == "dead_block":
                check(n_dead >= 64 * 32, f"B3 dead_block: {n_dead} dead")
            again = fa.flash_attention_bwd(*args, pq, pk, window=window)
            check(same_bits(got, again),
                  f"B3 {case} {dname}: two runs differ (no atomics: they "
                  f"must give the same bits)")
            rows["B3"]["max_abs_err"] = max(rows["B3"]["max_abs_err"], err)
            rows["B3"]["max_scaled_err"] = max(rows["B3"]["max_scaled_err"],
                                               scaled_err(got, want))
            checked.append(f"B3/{case}/{dname}")
    for dtype, (case, (sp, rank, window, cls)) in (
            (d, c) for d in (torch.bfloat16, torch.float32)
            for c in paged_cases().items()):
        dname = str(dtype).split(".")[-1]
        args = (*paged_inputs(dev, sp, cls, dtype=dtype, d=d, rank=rank),
                rank)
        kw = dict(sp=sp, page_size=16, window=window)
        o, lse = pd.paged_decode_attention(*args, **kw)
        torch.cuda.synchronize()
        o_p, lse_p = pd.paged_decode_attention_plain(*args, **kw)
        err, ok, _ = partial_err(o, lse, o_p, lse_p, TOL[dname])
        check(ok, f"B4 {case} {dname}: max err {err} (tol {TOL[dname]}) "
                  f"or a dead row not exact")
        if cls[-1] == 0:
            check(bool((lse[3] == NEG_INF).all()), f"B4 {case}: inactive")
        check(same_bits(pd.paged_decode_attention(*args, **kw), (o, lse)),
              f"B4 {case} {dname}: two runs differ (no atomics on values: "
              f"they must give the same bits)")
        rows["B4"]["max_abs_err"] = max(rows["B4"]["max_abs_err"], err)
        checked.append(f"B4/{case}/{dname}")
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for case, (sq, sk, window, rws, kind) in ragged_cases().items():
            (q, k, v), pq, pk = ragged_inputs(dev, dtype, sq, sk, rws, kind,
                                             d=d)
            o, lse = rp.ragged_prefill_fwd(q, k, v, pq, pk, window=window)
            torch.cuda.synchronize()
            o_p, lse_p = rp.ragged_prefill_fwd_plain(q, k, v, pq, pk,
                                                     window=window)
            err, ok, n_dead = partial_err(o, lse, o_p, lse_p, TOL[dname])
            check(ok, f"B5 {case} {dname}: max err {err} (tol {TOL[dname]})"
                      f" or a dead row not exact")
            if kind == "lengths":
                check(n_dead >= sq * 32, f"B5 {case}: {n_dead} dead rows")
            rows["B5"]["max_abs_err"] = max(rows["B5"]["max_abs_err"], err)
            checked.append(f"B5/{case}/{dname}")
        for case, (cached, window, holes, sp, rank) in \
                paged_prefill_cases().items():
            args = (*paged_prefill_inputs(dev, dtype, cached, holes, d=d,
                                          sp=sp, rank=rank), rank)
            kw = dict(sp=sp, page_size=16, window=window)
            o, lse = pp.paged_prefill_attention(*args, **kw)
            torch.cuda.synchronize()
            o_p, lse_p = pp.paged_prefill_attention_plain(*args, **kw)
            err, ok, n_dead = partial_err(o, lse, o_p, lse_p, TOL[dname])
            check(ok, f"B6 {case} {dname}: max err {err} (tol {TOL[dname]})"
                      f" or a dead row not exact")
            if 0 in cached:
                check(bool((lse[cached.index(0)] == NEG_INF).all()),
                      f"B6 {case}: the row with nothing cached is not dead")
            if case == "window_slid":
                check(0 < n_dead < lse.numel(), f"B6 {case}: {n_dead} dead")
            check(same_bits(pp.paged_prefill_attention(*args, **kw),
                            (o, lse)),
                  f"B6 {case} {dname}: two runs differ (no atomics: they "
                  f"must give the same bits)")
            rows["B6"]["max_abs_err"] = max(rows["B6"]["max_abs_err"], err)
            checked.append(f"B6/{case}/{dname}")
        for case, (b, sq, sk, hq, hkv, window, offs, zero) in \
                ragged_bwd_cases().items():
            args = ragged_bwd_inputs(dev, dtype, b, sq, sk, hq, hkv, window,
                                     offs, zero, d=d)
            got = rb.flash_attention_bwd_ragged(*args, window=window)
            torch.cuda.synchronize()
            want = rb.flash_attention_bwd_ragged_plain(*args, window=window)
            err, ok, n_dead = grad_err(got, want, args[4], BWD_TOL)
            check(ok, f"B7 {case} {dname}: max err {err} (tol {BWD_TOL}) "
                      f"or a dead row's dq not exactly 0")
            for r in zero:
                check(n_dead >= sq * hq and all(
                    bool((t[r] == 0).all()) for t in got),
                    f"B7 {case} {dname}: zero-length row {r} not exactly "
                    f"0 in dq, dk, dv")
            again = rb.flash_attention_bwd_ragged(*args, window=window)
            check(same_bits(got, again),
                  f"B7 {case} {dname}: two runs differ (no atomics: they "
                  f"must give the same bits)")
            rows["B7"]["max_abs_err"] = max(rows["B7"]["max_abs_err"], err)
            rows["B7"]["max_scaled_err"] = max(rows["B7"]["max_scaled_err"],
                                               scaled_err(got, want))
            checked.append(f"B7/{case}/{dname}")
            del got, want, again, args
    return checked


def phase_kernels(dev):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.kernels import ragged_bwd as rb
    from repro_torch.kernels import ragged_prefill as rp
    from repro_torch.kernels import ref

    rows = {n: {"name": n, "route": "cuda", "source": SOURCES[n],
                "replaces": REPLACES[n], "max_abs_err": 0.0,
                "device_ms": None, "library_device_ms": None}
            for n in KERNELS}
    for n in ("B3", "B7"):
        rows[n]["max_scaled_err"] = 0.0
    checked = check_cases(dev, rows)

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
            library_ms=None, work=(io, flops, "bfloat16")),
        "B2": dict(
            ms=time_ms(lambda: fa.flash_attention_fwd(
                q, k, v, pq, pq, o_acc, lse_acc, window=4096)),
            plain_ms=time_ms(lambda: fa.flash_attention_fwd_plain(
                q, k, v, pq, pq, o_acc, lse_acc, window=4096)),
            library_ms=None, work=(io + acc_io, flops, "bfloat16")),
    }
    # B1's yardstick: the faster of SDPA with the boolean mask (kv heads
    # repeated beforehand) and SDPA with is_causal and enable_gqa, the same
    # function at this shape (window 4096 is inert over 1024 keys)
    b1_sdpa = {
        "bool_mask": lambda: F.scaled_dot_product_attention(
            qt, kt_r, vt_r, attn_mask=mask),
        "is_causal_gqa": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)}
    b1_library = {n: time_ms(f) for n, f in b1_sdpa.items()}
    b1_library_device = {n: device_ms(f) for n, f in b1_sdpa.items()}
    timing["B1"]["library_ms"] = min(b1_library.values())
    # device time alone (device_ms): a call shorter than its Python
    # wrapper is paced by the host in time_ms
    timing["B1"].update(
        device_ms=device_ms(lambda: fa.flash_attention_fwd(
            q, k, v, pq, pq, window=4096)),
        library_device_ms=min(b1_library_device.values()))
    timing["B2"]["device_ms"] = device_ms(lambda: fa.flash_attention_fwd(
        q, k, v, pq, pq, o_acc, lse_acc, window=4096))
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
        device_ms=device_ms(lambda: pd.paged_decode_attention(
            qd, pk_, pv_, table, cl, rank, **kw)),
        library_ms=None, work=(nb, nf, "bfloat16"))
    paged_refs = {"B4": paged_sdpa(qd, pk_, pv_, table, cl, 16, window,
                                   decode=True)}
    # B5 at the legacy path's first decode step: 4 rows at cache length
    # 1024 against the capacity-sized cache (1024 prompt + 32 new tokens)
    (q5, k5, v5), pq5, pk5 = ragged_inputs(dev, torch.bfloat16, 1, 1056,
                                           [1024] * 4, "decode")
    mask5 = ref.make_mask(pq5, pk5, causal=True, window=4096)[:, None]
    qt5 = q5.transpose(1, 2)
    kt5, vt5 = (t.transpose(1, 2).repeat_interleave(4, dim=1)
                for t in (k5, v5))
    timing["B5"] = dict(
        ms=time_ms(lambda: rp.ragged_prefill_fwd(q5, k5, v5, pq5, pk5,
                                                 window=4096)),
        plain_ms=time_ms(lambda: rp.ragged_prefill_fwd_plain(
            q5, k5, v5, pq5, pk5, window=4096)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt5, kt5, vt5, attn_mask=mask5)),
        device_ms=device_ms(lambda: rp.ragged_prefill_fwd(
            q5, k5, v5, pq5, pk5, window=4096)),
        library_device_ms=device_ms(lambda: F.scaled_dot_product_attention(
            qt5, kt5, vt5, attn_mask=mask5)),
        work=(*ragged_work(q5, k5, pq5, pk5, 4096), "bfloat16"))
    # B6 at the prefix phase's shape: a 256-query chunk after a 1024-token
    # cached prefix
    args6 = paged_prefill_inputs(dev, torch.bfloat16, [1024], [])
    kw6 = dict(sp=1, page_size=16, window=4096)
    timing["B6"] = dict(
        ms=time_ms(lambda: pp.paged_prefill_attention(*args6, 0, **kw6)),
        plain_ms=time_ms(lambda: pp.paged_prefill_attention_plain(
            *args6, 0, **kw6)),
        device_ms=device_ms(lambda: pp.paged_prefill_attention(
            *args6, 0, **kw6)),
        library_ms=None,
        work=(*paged_prefill_work(args6[3].cpu().numpy(), [1024], 256,
                                  4096), "bfloat16"))
    paged_refs["B6"] = paged_sdpa(*args6, 16, 4096, decode=False)
    paged_refs = {n: dict(ms=time_ms(f), device_ms=device_ms(f))
                  for n, f in paged_refs.items()}
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
    b3_scaled = scaled_err(got, want)
    rows["B3"]["max_scaled_err"] = max(rows["B3"]["max_scaled_err"],
                                       b3_scaled)
    checked.append(f"B3/train_seq{S}/bfloat16")
    del got, want
    # one long block, 12288 tokens of 4 query heads over one kv head: dk
    # sums 4 x 12288 query rows, dq 12288 keys. The tensor cores' f32
    # accumulation truncates, so one MMA chain over the whole block would
    # drift past BWD_TOL; each tile's share is summed apart
    pl = torch.arange(LONG_BWD_SEQ, dtype=torch.int32, device=dev)
    largs = bwd_inputs(pl, pl, LONG_BWD_SEQ, torch.bfloat16, dev, seed=3,
                       heads=(4, 1))
    got = fa.flash_attention_bwd(*largs, pl, pl, window=LONG_BWD_SEQ)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(*largs, pl, pl, window=LONG_BWD_SEQ)
    long_err, ok, _ = grad_err(got, want, largs[4], BWD_TOL)
    long_scaled = scaled_err(got, want)
    check(ok, f"B3 long_seq{LONG_BWD_SEQ} bfloat16: max err {long_err} "
              f"(scaled {long_scaled}, tol {BWD_TOL})")
    rows["B3"]["max_abs_err"] = max(rows["B3"]["max_abs_err"], long_err)
    rows["B3"]["max_scaled_err"] = max(rows["B3"]["max_scaled_err"],
                                       long_scaled)
    checked.append(f"B3/long_seq{LONG_BWD_SEQ}/bfloat16")
    del got, want, largs
    # the same for the forward: B2 on one 12288-token block of 4 query heads
    # over one kv head, a row summing up to 12288 keys; each tile's P V goes
    # into a fresh accumulator before one f32 multiply-add
    gl = torch.Generator(device=dev).manual_seed(4)
    lq = torch.randn((1, LONG_FWD_SEQ, 4, 80), generator=gl, device=dev)
    lk, lv = (torch.randn((1, LONG_FWD_SEQ, 1, 80), generator=gl,
                          device=dev) for _ in range(2))
    lacc = (torch.randn((1, LONG_FWD_SEQ, 4, 80), generator=gl, device=dev),
            3 * torch.randn((1, 4, LONG_FWD_SEQ), generator=gl, device=dev))
    pl = torch.arange(LONG_FWD_SEQ, dtype=torch.int32, device=dev)
    largs = [t.bfloat16() for t in (lq, lk, lv)] + [pl, pl, *lacc]
    o2, lse2 = fa.flash_attention_fwd(*largs, window=LONG_FWD_SEQ)
    torch.cuda.synchronize()
    o2_p, lse2_p = fa.flash_attention_fwd_plain(*largs, window=LONG_FWD_SEQ)
    long_fwd_err, ok, _ = partial_err(o2, lse2, o2_p, lse2_p,
                                      TOL["bfloat16"])
    check(ok, f"B2 long_seq{LONG_FWD_SEQ} bfloat16: max err {long_fwd_err} "
              f"(tol {TOL['bfloat16']}) or a dead row not exact")
    rows["B2"]["max_abs_err"] = max(rows["B2"]["max_abs_err"], long_fwd_err)
    checked.append(f"B2/long_seq{LONG_FWD_SEQ}/bfloat16")
    del o2, lse2, o2_p, lse2_p, largs, lq, lk, lv, lacc
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
        lib_ms, lib_dev = sdpa_bwd_ms(q, k, v, do)
    except RuntimeError as e:      # no SDPA backend for these inputs
        lib_ms = lib_dev = None
        emit("kernels_note", library_B3=f"SDPA backward refused: {e}")
    timing["B3"] = dict(
        ms=time_ms(lambda: fa.flash_attention_bwd(*bargs, window=4096),
                   reps=10, inner=2),
        plain_ms=time_ms(lambda: fa.flash_attention_bwd_plain(
            *bargs, window=4096), reps=5, inner=2),
        device_ms=device_ms(lambda: fa.flash_attention_bwd(
            *bargs, window=4096), calls=5),
        library_ms=lib_ms, library_device_ms=lib_dev,
        work=(*bwd_work(q, k, pos, pos, pairs), "bfloat16"))
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
    # a reference, not B2's function: SDPA computes o alone, without lse
    # and without the merge into the running accumulator
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    b2_4096["sdpa_fwd_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True),
        reps=10, inner=2)
    b2_4096["device_ms"] = device_ms(lambda: fa.flash_attention_fwd(
        q, k, v, pos, pos, o_acc, lse_acc, window=4096), calls=5)
    b2_4096["sdpa_fwd_device_ms"] = device_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True), calls=5)
    del qt, kt, vt
    b2_4096["bound_ms"], b2_4096["bound_by"] = bound(
        fwd_io, 4 * 80 * 32 * pairs, "bfloat16")
    del q, k, v, do, o, lse, delta, o_acc, lse_acc, bargs
    # B7 at the ragged_bwd path's shape: 4 rows of 1024 tokens at their own
    # offsets, bf16, causal, window 4096
    b, sq, sk, hq, hkv, window, offs, zero = \
        ragged_bwd_cases()["path_4x1024"]
    args7 = ragged_bwd_inputs(dev, torch.bfloat16, b, sq, sk, hq, hkv,
                              window, offs, zero)
    q7, k7, v7, do7, _, _, pq7, pk7 = args7
    mask7 = ref.make_mask(pq7, pk7, causal=True, window=window)
    try:
        lib7, lib7_dev = sdpa_bwd_ms(q7, k7, v7, do7, mask7[:, None])
    except RuntimeError as e:      # no SDPA backend for these inputs
        lib7 = lib7_dev = None
        emit("kernels_note", library_B7=f"SDPA backward refused: {e}")
    timing["B7"] = dict(
        ms=time_ms(lambda: rb.flash_attention_bwd_ragged(*args7,
                                                         window=window),
                   reps=10, inner=2),
        plain_ms=time_ms(lambda: rb.flash_attention_bwd_ragged_plain(
            *args7, window=window), reps=5, inner=2),
        device_ms=device_ms(lambda: rb.flash_attention_bwd_ragged(
            *args7, window=window), calls=5),
        library_ms=lib7, library_device_ms=lib7_dev,
        work=(*bwd_work(q7, k7, pq7, pk7, int(mask7.sum())), "bfloat16"))
    del args7, q7, k7, v7, do7, mask7
    for name, t in timing.items():
        b_ms, b_by = bound(*t.pop("work"))
        rows[name].update(t, bound_ms=b_ms, bound_by=b_by,
                          tol=BWD_TOL if name in ("B3", "B7") else TOL)
    emit("kernels", checked=len(checked),
         tolerances="forward: f32 inputs 2e-5 (the JAX kernel tests' own); "
                    "bf16 inputs, upcast to f32 in both versions, 1e-4; "
                    "B3, B7: 3e-4 (the JAX test_bwd_matches_ref bound); "
                    "dead rows exact",
         timing_shapes={"B1/B2": "q (1,1024,32,80) bf16, causal, window "
                                 "4096",
                        "B3, B2_seq4096": "q (1,4096,32,80), k/v "
                                          "(1,4096,8,80) bf16, causal, "
                                          "window 4096",
                        "B4": "q (4,1,32,80) bf16, pool (512,16,8,80), W "
                              "64, ~1K context",
                        "B5": "q (4,1,32,80), k/v (4,1056,8,80) bf16, "
                              "cache length 1024 per row",
                        "B6": "q (1,256,32,80) bf16, pool (512,16,8,80), "
                              "W 128, cached_len 1024",
                        "B7": "q (4,1024,32,80), k/v (4,1024,8,80) bf16, "
                              "(B,S) positions at offsets 0/1024/2048/3072, "
                              "causal, window 4096"},
         library={"B1": "the faster of two scaled_dot_product_attention "
                        "calls (B1_library_ms), o only: the boolean mask "
                        "with kv heads repeated beforehand, and is_causal "
                        "with enable_gqa",
                  "B2_seq4096.sdpa_fwd_ms": "scaled_dot_product_attention "
                                            "(is_causal, enable_gqa): a "
                                            "reference that computes o "
                                            "only, without lse or the "
                                            "merge",
                  "B5": "scaled_dot_product_attention with the boolean "
                        "mask of the positions, kv heads repeated "
                        "beforehand",
                  "B3": "autograd backward of scaled_dot_product_attention"
                        "(is_causal, enable_gqa), timed alone",
                  "B7": "autograd backward of scaled_dot_product_attention"
                        " with the boolean (B,1,Sq,Sk) mask of the "
                        "positions, kv heads repeated beforehand, timed "
                        "alone",
                  "paged_refs": "references, not B4's or B6's function: "
                                "scaled_dot_product_attention (o only, no "
                                "lse) on the allocated pages' keys gathered "
                                "densely beforehand (the gather not timed), "
                                "kv heads repeated, the boolean mask of "
                                "key validity and window (none when every "
                                "pair is visible)"},
         paged_refs=paged_refs,
         B1_library_ms=b1_library, B1_library_device_ms=b1_library_device,
         B2_seq4096=b2_4096,
         **{f"B2_long_seq{LONG_FWD_SEQ}_max_abs_err": long_fwd_err},
         B3_seq4096_max_abs_err=b3_err,
         B3_seq4096_max_scaled_err=b3_scaled,
         **{f"B3_long_seq{LONG_BWD_SEQ}_max_scaled_err": long_scaled},
         bf16_bwd_occupancy_seq4096=fa.bwd_occupancy(80, S, S),
         fwd_occupancy={
             f"D80_seq{S}": fa.fwd_occupancy(80, S, S, 4),
             "D80_decode_sq1_sk1056": fa.fwd_occupancy(80, 1, 1056, 4)},
         **{n: {k: r[k] for k in ("ms", "plain_ms", "library_ms",
                                   "device_ms", "library_device_ms",
                                   "bound_ms", "bound_by", "max_abs_err",
                                   "max_scaled_err") if k in r}
            for n, r in rows.items()})
    return rows


ULYSSES_P = 8                  # the schemes phase's SP degree


def ulysses_positions(kind, n, p=ULYSSES_P):
    """Ulysses' positions at SP degree p: the zigzag shards concatenated in
    linear rank order, as its all-to-all gathers the sequence (unsorted),
    or the same tokens sorted."""
    import torch

    if kind == "sorted":
        return torch.arange(n, dtype=torch.int32)
    return torch.cat([_zigzag(r, n, p) for r in range(p)])


def phase_kernels_ulysses(dev, rows):
    """B1 and B3 at the shape Ulysses gives them at full width and P = 8:
    q (1, 4096, 4, 80) over k/v (1, 4096, 1, 80) (G = 4, one kv head),
    causal, window 4096, the positions in the all-to-all's order and
    sorted; bf16 and f32 against their plain versions (the kernels phase's
    tolerances), then ``device_ms`` and the bound of each on bf16."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    S, W = TRAIN_SEQ, 4096
    out = {}
    for kind in ("zigzag_concat", "sorted"):
        pos = ulysses_positions(kind, S).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            q, k, v, do, lse, delta = bwd_inputs(pos, pos, W, dtype, dev,
                                                 seed=6, heads=(4, 1))
            o, lse1 = fa.flash_attention_fwd(q, k, v, pos, pos, window=W)
            torch.cuda.synchronize()
            o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, pos, pos,
                                                      window=W)
            b1_err, ok, _ = partial_err(o, lse1, o_p, lse_p, TOL[dname])
            check(ok, f"B1 ulysses_{kind} {dname}: max err {b1_err} (tol "
                      f"{TOL[dname]}) or a dead row not exact")
            bargs = (q, k, v, do, lse, delta, pos, pos)
            got = fa.flash_attention_bwd(*bargs, window=W)
            torch.cuda.synchronize()
            want = fa.flash_attention_bwd_plain(*bargs, window=W)
            b3_err, ok, _ = grad_err(got, want, lse, BWD_TOL)
            check(ok, f"B3 ulysses_{kind} {dname}: max err {b3_err} (tol "
                      f"{BWD_TOL}) or a dead row's dq not exactly 0")
            rows["B1"]["max_abs_err"] = max(rows["B1"]["max_abs_err"],
                                            b1_err)
            rows["B3"]["max_abs_err"] = max(rows["B3"]["max_abs_err"],
                                            b3_err)
            rows["B3"]["max_scaled_err"] = max(
                rows["B3"]["max_scaled_err"], scaled_err(got, want))
            del o, lse1, o_p, lse_p, got, want
            if dtype != torch.bfloat16:
                continue
            pairs = visible_pairs(pos, pos, W)
            io = sum(t.numel() * t.element_size() for t in (q, k, v)) \
                + 2 * pos.numel() * 4 + q.numel() * 4 + 4 * S * 4
            b1_bound = bound(io, 4 * 80 * 4 * pairs, "bfloat16")
            b3_bound = bound(*bwd_work(q, k, pos, pos, pairs), "bfloat16")
            out[kind] = {
                "visible_pairs": pairs,
                "B1": {"max_abs_err": b1_err,
                       "device_ms": device_ms(lambda: fa.flash_attention_fwd(
                           q, k, v, pos, pos, window=W), calls=10),
                       "bound_ms": b1_bound[0], "bound_by": b1_bound[1]},
                "B3": {"max_abs_err": b3_err,
                       "device_ms": device_ms(lambda: fa.flash_attention_bwd(
                           *bargs, window=W), calls=5),
                       "bound_ms": b3_bound[0], "bound_by": b3_bound[1]}}
            del q, k, v, do, lse, delta, bargs
    emit("kernels_ulysses", shape="q (1,4096,4,80), k/v (1,4096,1,80), "
         "causal, window 4096", tol={"B1": TOL, "B3": BWD_TOL},
         positions={"zigzag_concat": "the 8 zigzag shards concatenated "
                                     "(Ulysses' all-to-all order)",
                    "sorted": "0..4095"}, **out)


# ---------------------------------------------------------------------------
# phase 4: StarTrail forward and backward on a P = 8 ThreadMesh on the card
# ---------------------------------------------------------------------------

# The ring's gradients against autograd of plain attention in f32 from the
# same bf16 inputs. Both see the bf16 inputs exactly; the ring also rounds o
# to bf16 before delta = rowsum(do * o) (as the model's backward does), which
# moves ds by up to a bf16 ulp of delta (2^-8 relative), so allow 1e-2 of
# each gradient's largest magnitude.
# ---------------------------------------------------------------------------
# phase 3b: the kernels at head size 128
# ---------------------------------------------------------------------------

D128 = 128
D128_SEQ = 4096          # GPT-7B's training shape: 32q/32kv heads, causal
MINITRON_CTX = [1023, 1010, 1000, 990]   # 4 decode slots at ~1K context


def phase_kernels_d128(dev, rows):
    """Every kernel at head size 128, the head size of GPT-7B, minitron-8b
    and deepseek-7b: the check cases of phase 3 again (bf16 and f32), then
    each kernel at the shape the dense phases give it, held against its
    plain version at the same ``TOL``/``BWD_TOL`` and timed beside its
    bound and, where one exists, SDPA: B1, B2 and B3 at GPT-7B's training
    shape (q, k, v (1,4096,32,128), causal), B4 at minitron-8b's decode
    step (4 slots at ~1K context, 32q/8kv, pages of 16), B6 at its
    256-query chunk after a 1024-token prefix, B5 at the legacy decode
    shape and B7 at the ragged_bwd shape, each at D = 128 with no window.
    The check cases include B4 and B6 at dense_serve's P = 8 shard shapes
    (``sp8_rank5``, ``sp8_rank3_prefix512``). Each row gains ``d128``; the
    ``-Xptxas -v`` lines of the D = 128 kernels show their registers and
    spills."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.kernels import ragged_bwd as rb
    from repro_torch.kernels import ragged_prefill as rp
    from repro_torch.kernels import ref

    d = D128
    res = {n: {"max_abs_err": 0.0} for n in KERNELS}
    for n in ("B3", "B7"):
        res[n]["max_scaled_err"] = 0.0
    checked = check_cases(dev, res, d=d)
    shapes = {}

    def hold(name, what, got, want, lse=None):
        """The kernel's output against the plain version's at the
        phase's tolerances."""
        if lse is None:
            err, ok, _ = partial_err(*got, *want, TOL["bfloat16"])
            tol = TOL["bfloat16"]
        else:
            err, ok, _ = grad_err(got, want, lse, BWD_TOL)
            res[name]["max_scaled_err"] = max(res[name]["max_scaled_err"],
                                              scaled_err(got, want))
            tol = BWD_TOL
        check(ok, f"{name} {what} bfloat16 D=128: max err {err} (tol "
                  f"{tol}) or a dead row not exact")
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
        checked.append(f"{name}/{what}/bfloat16")

    # B1, B2, B3 at GPT-7B's training shape (MHA, no window)
    g = torch.Generator(device=dev).manual_seed(11)
    S = D128_SEQ
    q, k, v, do = (torch.randn((1, S, 32, d), generator=g,
                               device=dev).bfloat16() for _ in range(4))
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    o_acc = torch.randn((1, S, 32, d), generator=g, device=dev)
    lse_acc = 3 * torch.randn((1, 32, S), generator=g, device=dev)
    o_acc[:, :96] = 0.0
    lse_acc[:, :, :96] = NEG_INF
    pairs = visible_pairs(pos, pos, None)
    for name, acc in (("B1", ()), ("B2", (o_acc, lse_acc))):
        got = fa.flash_attention_fwd(q, k, v, pos, pos, *acc)
        torch.cuda.synchronize()
        hold(name, f"gpt7b_seq{S}", got,
             fa.flash_attention_fwd_plain(q, k, v, pos, pos, *acc))
        shapes[name] = "q, k, v (1,4096,32,128) bf16, causal" + (
            ", merged into a running (o, lse)" if acc else "")
    del got
    o, lse = fa.flash_attention_fwd_plain(q, k, v, pos, pos)
    delta = torch.einsum("bshd,bshd->bhs", do.float(),
                         o.bfloat16().float()).contiguous()
    bargs = (q, k, v, do, lse, delta, pos, pos)
    got = fa.flash_attention_bwd(*bargs)
    torch.cuda.synchronize()
    hold("B3", f"gpt7b_seq{S}", got, fa.flash_attention_bwd_plain(*bargs),
         lse)
    check(same_bits(got, fa.flash_attention_bwd(*bargs)),
          "B3 D=128: two runs differ (no atomics: they must give the same "
          "bits)")
    shapes["B3"] = "q, k, v, do (1,4096,32,128) bf16, causal"
    del got, o
    io = sum(t.numel() * t.element_size() for t in (q, k, v, pos, pos)) \
        + q.numel() * 4 + 32 * S * 4
    acc_io = (o_acc.numel() + lse_acc.numel()) * 4
    flops = 4 * d * 32 * pairs
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    timing = {
        "B1": dict(ms=time_ms(lambda: fa.flash_attention_fwd(
            q, k, v, pos, pos), reps=10, inner=2),
            plain_ms=time_ms(lambda: fa.flash_attention_fwd_plain(
                q, k, v, pos, pos), reps=5, inner=2),
            device_ms=device_ms(lambda: fa.flash_attention_fwd(
                q, k, v, pos, pos), calls=5),
            library_ms=time_ms(sdpa, reps=10, inner=2),
            library_device_ms=device_ms(sdpa, calls=5),
            work=(io, flops, "bfloat16")),
        "B2": dict(ms=time_ms(lambda: fa.flash_attention_fwd(
            q, k, v, pos, pos, o_acc, lse_acc), reps=10, inner=2),
            plain_ms=time_ms(lambda: fa.flash_attention_fwd_plain(
                q, k, v, pos, pos, o_acc, lse_acc), reps=5, inner=2),
            device_ms=device_ms(lambda: fa.flash_attention_fwd(
                q, k, v, pos, pos, o_acc, lse_acc), calls=5),
            library_ms=None, library_device_ms=None,
            sdpa_fwd_device_ms=device_ms(sdpa, calls=5),
            work=(io + acc_io, flops, "bfloat16"))}
    del qt, kt, vt
    try:
        lib_ms, lib_dev = sdpa_bwd_ms(q, k, v, do)
    except RuntimeError as e:      # no SDPA backend for these inputs
        lib_ms = lib_dev = None
        emit("kernels_note", library_B3_d128=f"SDPA backward refused: {e}")
    timing["B3"] = dict(
        ms=time_ms(lambda: fa.flash_attention_bwd(*bargs), reps=10,
                   inner=2),
        plain_ms=time_ms(lambda: fa.flash_attention_bwd_plain(*bargs),
                         reps=5, inner=2),
        device_ms=device_ms(lambda: fa.flash_attention_bwd(*bargs),
                            calls=5),
        library_ms=lib_ms, library_device_ms=lib_dev,
        work=(*bwd_work(q, k, pos, pos, pairs), "bfloat16"))
    occupancy = {"bf16_bwd_seq4096": fa.bwd_occupancy(d, S, S),
                 "fwd_seq4096_g1": fa.fwd_occupancy(d, S, S, 1),
                 "fwd_decode_g4": fa.fwd_occupancy(d, 1, 1024, 4)}
    del q, k, v, do, lse, delta, o_acc, lse_acc, bargs
    free_device()

    # B4 at minitron-8b's decode step
    qd, pk_, pv_, table, cl = paged_inputs(dev, 1, MINITRON_CTX, seed=12,
                                           d=d)
    kw = dict(sp=1, page_size=16)
    args4 = (qd, pk_, pv_, table, cl, 0)
    got = pd.paged_decode_attention(*args4, **kw)
    torch.cuda.synchronize()
    hold("B4", "minitron_decode", got,
         pd.paged_decode_attention_plain(*args4, **kw))
    ref4 = paged_sdpa(qd, pk_, pv_, table, cl, 16, None, decode=True)
    timing["B4"] = dict(
        ms=time_ms(lambda: pd.paged_decode_attention(*args4, **kw)),
        plain_ms=time_ms(lambda: pd.paged_decode_attention_plain(
            *args4, **kw)),
        device_ms=device_ms(lambda: pd.paged_decode_attention(*args4, **kw)),
        library_ms=None, library_device_ms=None,
        gathered_sdpa_device_ms=device_ms(ref4),
        work=(*paged_work(table.cpu().numpy(), cl.cpu().numpy(), 1, 0,
                          None, d=d), "bfloat16"))
    shapes["B4"] = "q (4,1,32,128) bf16, pool (512,16,8,128), W 64, " \
        "cache lengths 1023/1010/1000/990"
    # B6 at minitron-8b's 256-query chunk after a 1024-token prefix
    args6 = (*paged_prefill_inputs(dev, torch.bfloat16, [1024], [], seed=13,
                                   d=d), 0)
    got = pp.paged_prefill_attention(*args6, **kw)
    torch.cuda.synchronize()
    hold("B6", "minitron_chunk", got,
         pp.paged_prefill_attention_plain(*args6, **kw))
    ref6 = paged_sdpa(*args6[:5], 16, None, decode=False)
    timing["B6"] = dict(
        ms=time_ms(lambda: pp.paged_prefill_attention(*args6, **kw)),
        plain_ms=time_ms(lambda: pp.paged_prefill_attention_plain(
            *args6, **kw)),
        device_ms=device_ms(lambda: pp.paged_prefill_attention(*args6,
                                                               **kw)),
        library_ms=None, library_device_ms=None,
        gathered_sdpa_device_ms=device_ms(ref6),
        work=(*paged_prefill_work(args6[3].cpu().numpy(), [1024], 256, None,
                                  d=d), "bfloat16"))
    shapes["B6"] = "q (1,256,32,128) bf16, pool (512,16,8,128), W 128, " \
        "cached_len 1024"
    del got, args4, args6, ref4, ref6
    # B5 at the legacy decode shape
    (q5, k5, v5), pq5, pk5 = ragged_inputs(dev, torch.bfloat16, 1, 1056,
                                           [1024] * 4, "decode", seed=14,
                                           d=d)
    got = rp.ragged_prefill_fwd(q5, k5, v5, pq5, pk5)
    torch.cuda.synchronize()
    hold("B5", "decode_sq1", got,
         rp.ragged_prefill_fwd_plain(q5, k5, v5, pq5, pk5))
    mask5 = ref.make_mask(pq5, pk5, causal=True)[:, None]
    qt5 = q5.transpose(1, 2)
    kt5, vt5 = (t.transpose(1, 2).repeat_interleave(4, dim=1)
                for t in (k5, v5))

    def sdpa5():
        return F.scaled_dot_product_attention(qt5, kt5, vt5,
                                              attn_mask=mask5)

    timing["B5"] = dict(
        ms=time_ms(lambda: rp.ragged_prefill_fwd(q5, k5, v5, pq5, pk5)),
        plain_ms=time_ms(lambda: rp.ragged_prefill_fwd_plain(
            q5, k5, v5, pq5, pk5)),
        device_ms=device_ms(lambda: rp.ragged_prefill_fwd(
            q5, k5, v5, pq5, pk5)),
        library_ms=time_ms(sdpa5), library_device_ms=device_ms(sdpa5),
        work=(*ragged_work(q5, k5, pq5, pk5, None), "bfloat16"))
    shapes["B5"] = "q (4,1,32,128), k/v (4,1056,8,128) bf16, cache " \
        "length 1024 per row"
    del got, q5, k5, v5, qt5, kt5, vt5, mask5
    # B7 at the ragged_bwd path's shape
    args7 = ragged_bwd_inputs(dev, torch.bfloat16, 4, 1024, 1024, 32, 8,
                              None, [0, 1024, 2048, 3072], [], seed=15, d=d)
    got = rb.flash_attention_bwd_ragged(*args7)
    torch.cuda.synchronize()
    hold("B7", "path_4x1024", got,
         rb.flash_attention_bwd_ragged_plain(*args7), args7[4])
    q7, k7, v7, do7, _, _, pq7, pk7 = args7
    mask7 = ref.make_mask(pq7, pk7, causal=True)
    try:
        lib7, lib7_dev = sdpa_bwd_ms(q7, k7, v7, do7, mask7[:, None])
    except RuntimeError as e:      # no SDPA backend for these inputs
        lib7 = lib7_dev = None
        emit("kernels_note", library_B7_d128=f"SDPA backward refused: {e}")
    timing["B7"] = dict(
        ms=time_ms(lambda: rb.flash_attention_bwd_ragged(*args7), reps=10,
                   inner=2),
        plain_ms=time_ms(lambda: rb.flash_attention_bwd_ragged_plain(
            *args7), reps=5, inner=2),
        device_ms=device_ms(lambda: rb.flash_attention_bwd_ragged(*args7),
                            calls=5),
        library_ms=lib7, library_device_ms=lib7_dev,
        work=(*bwd_work(q7, k7, pq7, pk7, int(mask7.sum())), "bfloat16"))
    shapes["B7"] = "q (4,1024,32,128), k/v (4,1024,8,128) bf16, (B,S) " \
        "positions at offsets 0/1024/2048/3072, causal"
    del got, args7, q7, k7, v7, do7, mask7
    for name, t in timing.items():
        b_ms, b_by = bound(*t.pop("work"))
        res[name].update(t, bound_ms=b_ms, bound_by=b_by, shape=shapes[name])
        rows[name]["d128"] = res[name]
    ptxas = [line for line in _build.build_info()["ptxas"]
             if "Li128E" in line]
    emit("kernels_d128", checked=len(checked), head_dim=d,
         tolerances="as phase 3: forward f32 2e-5, bf16 1e-4; B3, B7 3e-4; "
                    "dead rows exact",
         library={"B1": "scaled_dot_product_attention(is_causal), o only",
                  "B2.sdpa_fwd_device_ms": "the same call: a reference "
                                           "without lse or the merge",
                  "B3": "autograd backward of scaled_dot_product_attention"
                        "(is_causal), timed alone",
                  "B4/B6.gathered_sdpa_device_ms": "references: SDPA on "
                                                   "the pages' keys "
                                                   "gathered beforehand",
                  "B5": "scaled_dot_product_attention with the boolean "
                        "mask, kv heads repeated beforehand",
                  "B7": "autograd backward of scaled_dot_product_attention"
                        " with the boolean mask, kv heads repeated"},
         occupancy=occupancy, ptxas_d128=ptxas, kernels=res)


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
    check(launches == launches_of(B2=p * r, B3=p * r),
          f"ring launches {launches}: want B2 {p * r} and B3 {p * r} (every "
          f"ring step of every rank) and nothing else")
    emit("ring", c=c, r=r, P=p, N=N, window=window, dtype="bfloat16",
         max_abs_err=err, tol="1e-3 + |ref|/64",
         grad_err_over_max=grad_err, grad_tol=RING_GRAD_TOL,
         launches=launches, seconds=seconds)
    return launches


# ---------------------------------------------------------------------------
# phase 4a: the kernel layer's entries with per-row (B, S) positions
# ---------------------------------------------------------------------------

def phase_ragged_bwd(dev):
    """``dispatch.block_fwd`` (B5) and ``dispatch.block_bwd`` (B7) with
    (B, S) positions at the full width's heads. delta is taken from the f32
    o, so the backward is the exact gradient of attention in f32 at the
    bf16 inputs: autograd through the plain version of the same function
    differs only in the order of the sums (BWD_TOL)."""
    import torch

    from repro_torch.kernels import dispatch, ref

    b, sq, _, hq, hkv, window, offs, _ = ragged_bwd_cases()["path_4x1024"]
    g = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn((b, sq, hq, 80), generator=g, device=dev).bfloat16()
    k = torch.randn((b, sq, hkv, 80), generator=g, device=dev).bfloat16()
    v = torch.randn((b, sq, hkv, 80), generator=g, device=dev).bfloat16()
    do = torch.randn((b, sq, hq, 80), generator=g, device=dev).bfloat16()
    pos = (torch.tensor(offs, dtype=torch.int32, device=dev)[:, None]
           + torch.arange(sq, dtype=torch.int32, device=dev)[None])
    kw = dict(causal=True, window=window, impl="cuda")
    counts = reset_counts()
    t0 = time.perf_counter()
    o, lse = dispatch.block_fwd(q, k, v, pos, pos, **kw)
    delta = torch.einsum("bshd,bshd->bhs", do.float(), o).contiguous()
    got = dispatch.block_bwd(q, k, v, do, lse, delta, pos, pos, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts(counts)
    check(launches == launches_of(B5=1, B7=1),
          f"ragged_bwd launches {launches}: want B5 1 and B7 1")
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    o_ref, _ = ref.block_attention(*leaves, pos, pos, causal=True,
                                   window=window)
    want = torch.autograd.grad(o_ref, leaves, do.float())
    del o_ref, leaves
    err, ok, _ = grad_err(got, want, lse, BWD_TOL)
    check(ok and all(bool(torch.isfinite(t).all()) for t in got),
          f"ragged_bwd: gradients max err {err} against autograd of the "
          f"plain version (tol {BWD_TOL})")
    emit("ragged_bwd", rows=b, seq=sq, offsets=offs, heads=[hq, hkv],
         head_dim=80, window=window, dtype="bfloat16", max_abs_err=err,
         tol=BWD_TOL, launches=launches, seconds=seconds)
    return launches


# ---------------------------------------------------------------------------
# phase 5: the engine at full width
# ---------------------------------------------------------------------------

def reset_counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.kernels import ragged_bwd as rb
    from repro_torch.kernels import ragged_prefill as rp

    mods = (fa, pd, rp, pp, rb)
    for m in mods:
        m.reset_launches()
    return tuple(m.LAUNCHES for m in mods)


def read_counts(counts):
    out = {}
    for c in counts:
        out.update(c)
    return dict(out)


def launches_of(**counts):
    """The launch counts of a path that runs only the kernels named."""
    return {n: counts.get(n, 0) for n in KERNELS}


def p1_launches(engine):
    """One card: C = R = 1, so each layer's StarTrail forward is one ring
    step through B2 (merging into the empty accumulator), and each decode
    step runs B4 once a layer."""
    L, m = engine.cfg.num_layers, engine.metrics
    return launches_of(B2=L * m.prefills, B4=L * m.decode_steps)


def drive_engine(engine, smi, reqs, want, what, profile_steps=0,
                 later=()):
    """Serve ``reqs`` (then ``later``, each queued once every earlier
    request's prefill has completed) step by step, with every count set to
    0 just before and read just after; profile the first ``profile_steps``
    steps that decode with no prefill queued or in flight. Each request
    must stream its ``max_new_tokens`` in-vocab tokens, and the launches
    must equal ``want(engine)``. Returns the streams, the first-token
    hidden states, the launch counts and the run's record."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    hidden = {}
    engine.on_prefill = lambda uid, h: hidden.__setitem__(uid,
                                                          h.float().clone())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pending = list(later)
    decode_ms, window = [], None
    in_window = {"wall_s": 0.0, "decode_steps": 0, "decode_wall_s": 0.0,
                 "tokens": 0}
    counts = reset_counts()
    t0 = time.perf_counter()
    for r in reqs:
        check(engine.add_request(r) is None, f"{r.uid} rejected")
    while not engine.idle() or pending:
        if pending and engine.metrics.prefills == len(reqs) + len(later) \
                - len(pending):
            r = pending.pop(0)
            check(engine.add_request(r) is None, f"{r.uid} rejected")
        active = engine.scheduler.active()
        # a step that only decodes: nothing queued, every prefill done
        pure = not engine.scheduler.queue and bool(active) \
            and all(st.cache_len > 0 for st in active)
        profiled = pure and window is None and profile_steps > 0
        t1 = time.perf_counter()
        if profiled:
            m = engine.metrics
            before = (m.decode_steps, m.decode_wall_s, m.tokens_out)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(profile_steps):
                    engine.step()
                torch.cuda.synchronize()
            window = _profile_window(prof, profile_steps,
                                     time.perf_counter() - t1)
            del prof
            # the window's steps and the reading of its trace
            in_window = {"wall_s": time.perf_counter() - t1,
                         "decode_steps": m.decode_steps - before[0],
                         "decode_wall_s": m.decode_wall_s - before[1],
                         "tokens": m.tokens_out - before[2]}
            emitted = [True]
        else:
            emitted = engine.step()
            if pure:
                decode_ms.append(1e3 * (time.perf_counter() - t1))
        check(bool(emitted) or bool(engine.scheduler.active()),
              "engine stalled")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counts)
    engine.on_prefill = None
    out = engine.collect()
    vocab = engine.cfg.vocab_size
    for r in (*reqs, *later):
        toks = out.get(r.uid, [])
        check(len(toks) == r.max_new_tokens
              and all(0 <= t < vocab for t in toks),
              f"{what} {r.uid}: {len(toks)} tokens, want "
              f"{r.max_new_tokens} in-vocab")
    m = engine.metrics
    expected = want(engine)
    check(launches == expected,
          f"{what} launches {launches}: want {expected} ({m.prefills} "
          f"prefills, {m.prefill_chunks} chunks, {m.decode_steps} decode "
          f"steps)")
    rec = {"P_sp": engine.sp, "C": engine.plan.c, "R": engine.plan.r,
           "scheme": engine.plan.scheme,
           "comm_chunks": engine.plan.comm_chunks, "wall_s": wall,
           "prefills": m.prefills, "prefill_chunks": m.prefill_chunks,
           "decode_steps": m.decode_steps, "prefill_s": m.prefill_wall_s,
           "ttft_s": dict(engine.ttft_s),
           "decode_step_wall_ms_median": (statistics.median(decode_ms)
                                          if decode_ms else None),
           "decode_step_profile": window, "profiled": in_window,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": launches, "card": smi}
    return out, hidden, launches, rec


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
    plens = [64, 200, 336, 472, 608, 744, 880, 1024]
    reqs = [Request(f"req{i}", rng.integers(0, cfg.vocab_size, n).tolist(),
                    32) for i, n in enumerate(plens)]
    # the process's first profiler start takes seconds: keep it out of
    # the profiled decode window
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device=dev).add_(1)
        torch.cuda.synchronize()
    out, _, launches, rec = drive_engine(engine, smi, reqs, p1_launches,
                                         "engine", profile_steps=4)
    m, prof = engine.metrics, rec["profiled"]
    # the mean step and the rate leave out the profiled window and the
    # reading of its trace, so they compare with runs that profiled
    # nothing; wall_s is the whole run
    emit("engine", model=cfg.name, params=model.param_count(),
         weights="seeded random bf16", init_s=init_s, requests=len(reqs),
         prompt_lens=plens, new_tokens=32, launches=launches,
         prefills=m.prefills, decode_steps=m.decode_steps,
         ttft_s=rec["ttft_s"],
         mean_decode_step_ms=1e3 * (m.decode_wall_s - prof["decode_wall_s"])
         / max(m.decode_steps - prof["decode_steps"], 1),
         decode_step_wall_ms_median=rec["decode_step_wall_ms_median"],
         decode_step_profile=rec["decode_step_profile"],
         prefill_s=m.prefill_wall_s, wall_s=rec["wall_s"],
         profiled_wall_s=prof["wall_s"],
         tokens_per_s=(m.tokens_out - prof["tokens"])
         / (rec["wall_s"] - prof["wall_s"]),
         max_memory_allocated=rec["max_memory_allocated"], card=smi)
    return engine, reqs, out, launches, rec


SAMPLE_MIX = {"temperature": 0.9, "top_k": (0, 16, 32),
              "top_p": (1.0, 0.9, 0.8), "seed": 100}
# the 0.999 quantile of chi-square with 7 degrees of freedom: 8 categories
CHI2_999_DF7 = 24.3
SAMPLE_DRAWS = {"vocab": 32000, "rows": 4, "draws": 4096, "top_k": 8,
                "top_p": 0.4}


def sampled_mix(reqs):
    """``check_engine_mixed``'s sampling settings on ``reqs``: even
    requests greedy, odd ones at temperature 0.9 with top-k 0/16/32 and
    top-p 1.0/0.9/0.8 in turn, seeds 100 + i."""
    import dataclasses

    mix = SAMPLE_MIX
    return [dataclasses.replace(
        r, temperature=0.0 if i % 2 == 0 else mix["temperature"],
        top_k=mix["top_k"][i % 3], top_p=mix["top_p"][i % 3],
        seed=mix["seed"] + i) for i, r in enumerate(reqs)]


def solo_streams(engine, reqs, before_step=None):
    """Each request served alone on ``engine``, ``before_step(engine)``
    called before every step. Returns uid -> stream and uid -> [(step,
    wall ms)] of the steps that only decode."""
    out, walls = {}, {}
    for r in reqs:
        engine.reset()
        check(engine.add_request(r) is None, f"{r.uid} rejected")
        walls[r.uid] = []
        while not engine.idle():
            if before_step is not None:
                before_step(engine)
            pure = bool(engine.scheduler.active()) \
                and not engine.scheduler.queue
            step = engine.metrics.steps
            t0 = time.perf_counter()
            engine.step()
            if pure:
                walls[r.uid].append((step, 1e3 * (time.perf_counter() - t0)))
        out[r.uid] = engine.collect()[r.uid]
    return out, walls


def _median_ms(walls, keep):
    """Median of ``solo_streams``' step walls for which ``keep(uid, step)``."""
    ms = [w for uid, ws in walls.items() for step, w in ws if keep(uid, step)]
    return statistics.median(ms) if ms else None


def _sample_draws(dev):
    """``engine.sampling.sample`` on CUDA tensors at V = 32000, 4 rows:
    4096 draws at temperature 1 with top-k 8 (every draw in the top 8, and
    the chi-square of the counts against the softmax over those 8 below
    its 0.999 quantile) and with top-p 0.4 (every draw in the nucleus);
    each draw keyed by (row, draw) through ``fold_in``."""
    import types

    import numpy as np
    import torch

    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.startrail import StarTrailConfig
    from repro_torch.dist.comm import SingleComm
    from repro_torch.engine import sampling
    from repro_torch.models.runtime import Runtime

    d = SAMPLE_DRAWS
    V, B = d["vocab"], d["rows"]
    logits = 3.0 * np.random.default_rng(3).normal(size=V).astype(np.float32)
    cfg = ModelConfig(name="draws", family="dense", num_layers=1,
                      d_model=1, num_heads=1, num_kv_heads=1, d_ff=1,
                      vocab_size=V)
    rt = Runtime(comm=SingleComm(), st_cfg=StarTrailConfig(
        seq_len=8, seq_scheme="contiguous"), device=dev)
    head = types.SimpleNamespace(
        table=torch.from_numpy(logits[:, None]).to(dev))
    x = torch.ones(B, 1, 1, device=dev)

    def rows(v, dt):
        return torch.full((B,), v, dtype=dt, device=dev)

    def draw(top_k, top_p):
        toks = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(d["draws"] // B):
            keys = [sampling.fold_in(sampling.seed_key(b), i)
                    for b in range(B)]
            toks.append(sampling.sample(
                rt, head, x, cfg, temperature=rows(1.0, torch.float32),
                top_k=rows(top_k, torch.int32),
                top_p=rows(top_p, torch.float32), keys=keys)[:, 0])
        toks = torch.cat(toks).cpu().numpy()
        ms = 1e3 * (time.perf_counter() - t0) / (d["draws"] // B)
        return toks, ms

    top = np.argsort(-logits)[:d["top_k"]]
    k_toks, k_ms = draw(d["top_k"], 1.0)
    check(np.isin(k_toks, top).all(), f"sample: top-k {d['top_k']} drew "
          f"{sorted(set(k_toks) - set(top))[:5]} outside the top {d['top_k']}")
    p = np.exp(logits[top].astype(np.float64) - logits[top].max())
    p /= p.sum()
    counts = np.array([(k_toks == t).sum() for t in top])
    chi2 = float(((counts - len(k_toks) * p) ** 2
                  / (len(k_toks) * p)).sum())
    check(chi2 < CHI2_999_DF7, f"sample: chi-square {chi2:.2f} of the top-k "
          f"draws against the softmax, bound {CHI2_999_DF7}")
    probs = np.exp(logits.astype(np.float64) - logits.max())
    probs /= probs.sum()
    order = np.argsort(-probs)
    nucleus = order[:int(np.searchsorted(np.cumsum(probs[order]),
                                         d["top_p"]) + 1)]
    p_toks, p_ms = draw(0, d["top_p"])
    check(np.isin(p_toks, nucleus).all(),
          f"sample: top-p {d['top_p']} drew outside its {len(nucleus)}-token "
          "nucleus")
    return {**d, "chi2_top_k": chi2, "chi2_bound": CHI2_999_DF7,
            "top_k_counts": counts.tolist(), "top_k_expected":
            (len(k_toks) * p).tolist(), "nucleus_size": len(nucleus),
            "distinct_top_p_draws": int(len(set(p_toks.tolist()))),
            "ms_per_call": {"top_k": k_ms, "top_p": p_ms}}


def _launch_serve_flags(dev):
    """``launch.serve`` in-process on the card at smoke width with the
    sampling and observability flags; ``--kernel ref``, as the smoke
    model's head size 16 is not one the kernels take."""
    import tempfile

    from repro_torch import obs
    from repro_torch.launch import serve

    with tempfile.TemporaryDirectory() as tmp:
        prom, trace = (os.path.join(tmp, n) for n in ("m.prom", "t.json"))
        out = serve.main(["--arch", ARCH, "--smoke", "--device", dev.type,
                          "--kernel", "ref", "--requests", "4",
                          "--temperature", "0.8", "--top-k", "40",
                          "--top-p", "0.9", "--metrics-dump", prom,
                          "--trace-out", trace])
        parsed = obs.parse_prometheus(open(prom).read())
        events = json.load(open(trace))["traceEvents"]
    n_tok = sum(len(v) for v in out.values())
    check(parsed[("engine_tokens_out_total", ())] == n_tok
          and sum(e["ph"] == "b" for e in events) == len(out)
          == sum(e["ph"] == "e" for e in events),
          f"launch.serve: {parsed.get(('engine_tokens_out_total', ()))} "
          f"tokens counted, {n_tok} streamed; request spans unmatched")
    return {"requests": len(out), "tokens": n_tok,
            "trace_events": len(events)}


def phase_sample(engine, smi, reqs, greedy_out, greedy_rec):
    """Sampled decoding on the engine phase's model and plan (P = 1):
    the engine phase's 8 prompts and budgets with ``sampled_mix``'s
    settings, through an engine with an ``obs.Registry`` and an enabled
    ``Tracer``. The greedy requests' streams must equal the engine phase's
    (another batch: that is their batch invariance), every sampled
    request's must equal serving it alone; the registry's and the trace's
    counts must match the run. Beside: the decode-step wall and device ms
    of this mixed window against the engine phase's all-greedy window (the
    same steps: the same prompts and budgets), the tracer on against
    ``NULL_TRACER`` on alternate steps of the solo runs, ``sample``
    on CUDA tensors (``_sample_draws``), and ``launch.serve`` with the
    flags. Returns the mixed run's launch counts."""
    import tempfile

    from repro_torch import obs
    from repro_torch.engine import Engine

    reg, tracer = obs.Registry(), obs.Tracer(enabled=True)
    eng = Engine(engine.model, engine.plan, engine.eng, registry=reg,
                 tracer=tracer)
    sreqs = sampled_mix(reqs)
    out, _, launches, rec = drive_engine(eng, smi, sreqs, p1_launches,
                                         "sample", profile_steps=4)
    for i, r in enumerate(sreqs):
        if i % 2 == 0:
            check(out[r.uid] == greedy_out[r.uid], f"sample: greedy "
                  f"{r.uid}'s stream differs from the engine phase's")
    check(any(out[r.uid] != greedy_out[r.uid] for r in sreqs[1::2]),
          "sample: every sampled stream equals its greedy stream")
    m = eng.metrics
    with tempfile.TemporaryDirectory() as tmp:
        reg.dump(os.path.join(tmp, "m.prom"))
        reg.dump(os.path.join(tmp, "m.json"), fmt="json")
        tracer.dump(os.path.join(tmp, "trace.json"))
        parsed = obs.parse_prometheus(open(os.path.join(tmp, "m.prom"))
                                      .read())
        events = json.load(open(os.path.join(tmp, "trace.json"))
                           )["traceEvents"]
    n_tok = sum(len(v) for v in out.values())
    got = {k: parsed[(k, ())] for k in (
        "engine_tokens_out_total", "serve_ttft_seconds_count",
        "serve_intertoken_seconds_count")}
    check(got == {"engine_tokens_out_total": n_tok,
                  "serve_ttft_seconds_count": m.prefills,
                  "serve_intertoken_seconds_count": n_tok - m.prefills},
          f"sample: dumped metrics {got}: {n_tok} tokens streamed, "
          f"{m.prefills} prefills")
    begins = sorted(e["args"]["uid"] for e in events if e["ph"] == "b")
    ends = [e for e in events if e["ph"] == "e"]
    steps = sum(e["name"] == "engine/step" for e in events)
    check(begins == sorted(r.uid for r in sreqs) and len(ends) == len(sreqs)
          and {e["id"] for e in ends} == {e["id"] for e in events
                                          if e["ph"] == "b"}
          and steps == m.steps,
          f"sample: trace has {len(begins)} request begins, {len(ends)} "
          f"ends, {steps} engine/step spans for {m.steps} steps")
    spans_per_step = len(events) / m.steps
    quantiles = m.latency_quantiles()

    # each sampled request alone, the tracer on for even steps and off for
    # odd
    tracer.clear()

    def toggle(e):
        e.tracer = tracer if e.metrics.steps % 2 == 0 else obs.NULL_TRACER

    sampled = [r for r in sreqs if r.temperature > 0]
    solo, walls = solo_streams(eng, sampled, toggle)
    eng.tracer = tracer
    for r in sampled:
        check(solo[r.uid] == out[r.uid], f"sample: {r.uid} alone gives "
              f"{solo[r.uid][:8]}..., in the mix {out[r.uid][:8]}...")
    draws = _sample_draws(eng.device)
    flags = _launch_serve_flags(eng.device)
    emit("sample", model=eng.cfg.name, requests=len(sreqs),
         settings=[{"uid": r.uid, "temperature": r.temperature,
                    "top_k": r.top_k, "top_p": r.top_p, "seed": r.seed}
                   for r in sreqs], launches=launches,
         greedy_equal_engine_phase=True, sampled_solo_equal_mixed=True,
         decode_step_wall_ms_median={
             "all_greedy": greedy_rec["decode_step_wall_ms_median"],
             "mixed": rec["decode_step_wall_ms_median"]},
         decode_window={"all_greedy": greedy_rec["decode_step_profile"],
                        "mixed": rec["decode_step_profile"]},
         tracer={"solo_decode_step_wall_ms_median": {
             "on": _median_ms(walls, lambda u, s: s % 2 == 0),
             "off": _median_ms(walls, lambda u, s: s % 2 == 1)},
             "steps_each": sum(len(w) for w in walls.values()) / 2,
             "events_per_step": spans_per_step},
         metrics=got, latency_quantiles=quantiles, draws=draws,
         launch_serve=flags, wall_s=rec["wall_s"], card=smi)
    del eng
    return launches


def next_token(engine, prompt, rt=None):
    """(hidden state, logits) of ``prompt``'s next token, both f32."""
    last, _ = engine.prefill_hidden(prompt, rt=rt)
    return last.float(), _logits(engine, last)


def _logits(engine, hidden):
    """The (1, V) f32 logits of a (1, 1, D) next-token hidden state."""
    import torch

    from repro_torch.engine import sampling

    with torch.no_grad():
        logits, _ = sampling.shard_logits(engine.rt, engine.model.head,
                                          hidden, engine.cfg)
    return logits


def compare(got, want, what, tol=None):
    """Relative L2 error and largest error over the largest magnitude of
    the hidden state and the logits, checked against ``tol`` (default
    ``ENGINE_TOL``)."""
    import torch

    tol = tol or ENGINE_TOL
    errs = {}
    for i, name in enumerate(("hidden", "logits")):
        a, b = got[i], want[i]
        errs[name] = {"rel_l2": float((a - b).norm() / b.norm()),
                      "max_abs_over_max": float((a - b).abs().max()
                                                / b.abs().max())}
        check(bool(torch.isfinite(a).all())
              and all(errs[name][k] <= tol[k] for k in tol),
              f"{what} {name}: {errs[name]} beyond {tol}")
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
    check(launches == launches_of(B1=L),
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


PREFIX_LEN, PREFIX_CHUNK = 1024, 256
PREFIX_SUFFIXES = [64, 128, 192, 256, 320, 384, 448, 512]


def _prefix_engine(model, prefix_cache):
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.plan import make_serve_plan

    plan = make_serve_plan(model.cfg, arch=ARCH, c=1, decode_batch=4,
                           page_size=16, max_len=2048,
                           prefix_cache=prefix_cache)
    return Engine(model, plan, EngineConfig(pages_per_shard=512,
                                            prefill_chunk=PREFIX_CHUNK))


def _alone_ttft(engine, prompts):
    """TTFT of each prompt served alone (one new token) in ``engine``."""
    from repro_torch.engine import Request

    out = []
    for prompt in prompts:
        uid = f"alone{len(engine.ttft_s)}"
        check(engine.add_request(Request(uid, prompt, 1)) is None,
              f"{uid} rejected")
        engine.run()
        out.append(engine.ttft_s[uid])
    return out


def phase_prefix(model, smi, reps=3):
    """The engine with the prefix cache and chunked prefill at full width:
    8 greedy requests sharing a 1024-token prefix, each with its own suffix.
    Requests that arrive once the prefix is registered prefill only their
    suffix (B6 for the cached pages, B1 for the suffix itself); every
    request's first token and next-token hidden state are held against a
    monolithic prefill of its prompt. Then TTFT of one request alone, with
    the prefix cached and without the cache (no claim)."""
    import numpy as np
    import torch

    from repro_torch.engine import Request

    cfg = model.cfg
    engine = _prefix_engine(model, prefix_cache=True)
    rng = np.random.default_rng(5)
    shared = rng.integers(0, cfg.vocab_size, PREFIX_LEN).tolist()
    reqs = [Request(f"pre{i}", shared
                    + rng.integers(0, cfg.vocab_size, n).tolist(), 32)
            for i, n in enumerate(PREFIX_SUFFIXES)]
    hidden = {}
    engine.on_prefill = lambda uid, h: hidden.__setitem__(uid,
                                                          h.float().clone())
    counts = reset_counts()
    t0 = time.perf_counter()
    for r in reqs:
        check(engine.add_request(r) is None, f"{r.uid} rejected")
    out = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counts)
    engine.on_prefill = None
    m = engine.metrics
    stats = m.to_dict()
    ttft_run = {r.uid: engine.ttft_s[r.uid] for r in reqs}
    cached = {r.uid: engine.scheduler.finished[r.uid].cached_len
              for r in reqs}
    for r in reqs:
        toks = out.get(r.uid, [])
        check(len(toks) == 32 and all(0 <= t < cfg.vocab_size for t in toks),
              f"{r.uid}: {len(toks)} tokens, want 32 in-vocab")
    check(m.prefill_tokens_cached > 0 and launches["B6"] > 0,
          f"prefix: {m.prefill_tokens_cached} cached tokens, B6 launched "
          f"{launches['B6']} times")
    L = cfg.num_layers
    cold = sum(1 for c in cached.values() if c == 0)
    want = launches_of(B1=L * (m.prefill_chunks - cold), B2=L * cold,
                       B4=L * m.decode_steps,
                       B6=L * (m.prefill_chunks - cold))
    check(launches == want, f"prefix launches {launches}: want {want} "
          f"({cold} leading chunks of {m.prefill_chunks}, "
          f"{m.decode_steps} decode steps)")
    errs = {}
    for r in reqs:
        want_h = next_token(engine, r.tokens)
        got = (hidden[r.uid], _logits(engine, hidden[r.uid]))
        errs[r.uid] = compare(got, want_h, f"prefix {r.uid} vs monolithic")
        check(out[r.uid][0] == int(want_h[1].argmax()),
              f"prefix {r.uid}: first token {out[r.uid][0]} is not the "
              f"monolithic prefill's argmax {int(want_h[1].argmax())}")
    ttft = {}
    for name, pc in (("cached", True), ("uncached", False)):
        eng = engine if pc else _prefix_engine(model, prefix_cache=False)
        ttft[name] = {}
        for n in (64, 256, 512):
            prompts = [shared + rng.integers(0, cfg.vocab_size, n).tolist()
                       for _ in range(reps)]
            ttft[name][n] = statistics.median(_alone_ttft(eng, prompts))
        del eng
    emit("prefix", model=cfg.name, prefix_len=PREFIX_LEN,
         prefill_chunk=PREFIX_CHUNK, suffix_lens=PREFIX_SUFFIXES,
         new_tokens=32, launches=launches, cached_len=cached,
         **{k: stats[k] for k in (
             "prefill_tokens_cached", "prefill_tokens_computed",
             "prefill_chunks", "prefills", "decode_steps",
             "prefix_hit_rate", "prefill_wall_s", "decode_wall_s")},
         ttft_s=ttft_run,
         alone_ttft_median_s={"suffix_tokens": [64, 256, 512], **ttft},
         err_vs_monolithic=errs, tol=ENGINE_TOL, wall_s=wall, card=smi)
    return launches


LEGACY_BATCH, LEGACY_PROMPT, LEGACY_GEN = 4, 1024, 32


def phase_legacy(engine, smi):
    """The static-batch path (``launch.serve.legacy_generate``) at full
    width: 4 prompts of 1024 tokens, 32 greedy tokens, B5 once per layer
    and decode step. Its first decode step's hidden state and token are
    held against the engine's prefill of the prompt and first token."""
    import numpy as np
    import torch

    from repro_torch.engine import Request
    from repro_torch.launch.serve import legacy_generate, legacy_start

    model, cfg = engine.model, engine.cfg
    dev = model.device
    B, S, G = LEGACY_BATCH, LEGACY_PROMPT, LEGACY_GEN
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (B, S))).to(dev)
    plan = engine.plan
    counts = reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = legacy_generate(model, plan, tokens, G)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counts)
    check(tuple(out.shape) == (B, G)
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"legacy tokens {tuple(out.shape)}: want ({B}, {G}) in-vocab")
    L = cfg.num_layers
    want = launches_of(B2=L, B5=L * (G - 1))
    check(launches == want, f"legacy launches {launches}: want {want} (one "
          f"batched prefill, B5 once per layer in each of {G - 1} decode "
          f"steps)")
    # the first decode step's hidden state, by the same steps
    tok0, cache, decode = legacy_start(model, plan, tokens, G)
    h1 = decode(cache, tok0.long(), torch.full((B,), S, dtype=torch.int32,
                                              device=dev),
                return_hidden=True)
    # host ms of 8 further decode steps, each ending in its tokens on the
    # host (the legacy loop keeps them on the card until the end)
    tok = tok0.long()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(8):
        tok = decode(cache, tok, torch.full((B,), S + 1 + i,
                                            dtype=torch.int32,
                                            device=dev)).long()
        tok.cpu()
    step_ms = 1e3 * (time.perf_counter() - t1) / 8
    del cache
    # the engine: the same prompts, two tokens each
    engine.reset()
    for b in range(B):
        engine.add_request(Request(f"leg{b}", tokens[b].tolist(), 2))
    eng_out = engine.run()
    errs, same = {}, True
    for b in range(B):
        uid = f"leg{b}"
        check(eng_out[uid][0] == int(out[b, 0]),
              f"legacy row {b}: prefill token {int(out[b, 0])} != the "
              f"engine's {eng_out[uid][0]}")
        want_h = next_token(engine, tokens[b].tolist() + [eng_out[uid][0]])
        got = (h1[b:b + 1].float(), _logits(engine, h1[b:b + 1]))
        errs[uid] = compare(got, want_h, f"legacy row {b} decode step")
        same &= int(got[1].argmax()) == int(want_h[1].argmax()) \
            == eng_out[uid][1] == int(out[b, 1])
    check(same, "legacy first decode tokens differ from the engine's")
    emit("legacy", model=cfg.name, batch=B, prompt_len=S, new_tokens=G,
         launches=launches, wall_s=wall, tokens_per_s=B * G / wall,
         decode_step_ms=step_ms, err_vs_engine=errs, tol=ENGINE_TOL,
         card=smi)
    return launches


def serving_phases(dev, smi):
    """The serving phases on one model; returns the launch counts of the
    engine, the sample phase, the local prefill, the prefix phase and the
    legacy phase (the engines and the model are freed after)."""
    engine, reqs, out, engine_launches, rec = phase_engine(dev, smi)
    sample_launches = phase_sample(engine, smi, reqs, out, rec)
    free_device()
    prompt = reqs[5].tokens
    startrail_route = phase_engine_check(engine, prompt)
    local_launches = phase_local(engine, prompt, startrail_route)
    phase_profile(engine, smi)
    prefix_launches = phase_prefix(engine.model, smi)
    legacy_launches = phase_legacy(engine, smi)
    return (engine_launches, sample_launches, local_launches,
            prefix_launches, legacy_launches)


# ---------------------------------------------------------------------------
# phases 9-11: training at the full width
# ---------------------------------------------------------------------------

TRAIN_SEQ, TRAIN_STEPS, TRAIN_MICRO = 4096, 4, 4
# bf16 params and grads, f32 grad accumulators and moments, the recomputed
# activations of one microbatch
TRAIN_RECKONED_BYTES = 32e9


class RepeatBatch:
    """A data source that serves one batch at every step: a loss that falls
    over a few steps shows the model learns (memorises) it."""

    def __init__(self, source):
        self.batch = source.get_batch(0)

    def get_batch(self, step):
        return self.batch


def _train_shape(seq, batch=1):
    from repro_torch.configs.base import ShapeConfig

    return ShapeConfig(f"train_{seq // 1024}k_b{batch}", seq, batch, "train")


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
    shape = _train_shape(TRAIN_SEQ, TRAIN_MICRO)
    plan = make_plan(cfg, shape, arch=ARCH, c=1, microbatches=TRAIN_MICRO)
    check(plan.remat == "attn_out", f"plan remat {plan.remat!r}: the "
          f"default is 'attn_out', as in the JAX plan")
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
    L, M = cfg.num_layers, plan.microbatches
    want = launches_of(B2=2 * L * M * TRAIN_STEPS, B3=L * M * TRAIN_STEPS)
    check(launches == want, f"train launches {launches}: want {want} (per "
          f"layer and microbatch, the ring step forward twice under "
          f"recompute and backward once)")
    step_ms = [1e3 * r["step_s"] for r in recs]
    # step_s of step i is its dispatch plus the wait on step i-1; from the
    # third step on it is the steady device step
    steady = statistics.median(step_ms[2:])
    emit("train", model=cfg.name, params=model.param_count(),
         weights="seeded random bf16", init_s=init_s,
         shape={"seq_len": shape.seq_len, "batch": shape.global_batch},
         plan={"P_sp": plan.sp_size, "C": plan.c, "R": plan.r,
               "seq_scheme": plan.seq_scheme, "block_impl": plan.block_impl,
               "remat": plan.remat, "microbatches": plan.microbatches},
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


def phase_train_check(model, dev, phase="train_check"):
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
          f"{phase}: loss rel {loss_rel}, worst grad leaf {worst} rel "
          f"L2 {rel[worst]}, beyond {TRAIN_CHECK_TOL}")
    emit(phase, seq_len=shape.seq_len, batch=1,
         loss={"cuda": float(loss_c), "ref": float(loss_r)},
         loss_rel=loss_rel, loss_rel_tol=TRAIN_CHECK_TOL["loss_rel"],
         grad_rel_l2_worst={"leaf": worst, "value": rel[worst]},
         grad_rel_l2_median=statistics.median(rel.values()),
         grad_rel_l2_tol=TRAIN_CHECK_TOL["grad_rel_l2"], leaves=len(rel))


def phase_train_profile(model, dev, smi):
    """Where a train step's time goes: ``torch.profiler`` over one
    full-width step of one sequence without recompute and one with
    ``remat='attn_out'``, each after one unprofiled step; the peak memory
    of each profiled step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.plan import make_plan
    from repro_torch.train import step as train_step

    shape = _train_shape(TRAIN_SEQ)
    adam = adamw.AdamWConfig(learning_rate=1e-3, warmup_steps=0)
    batch = train_step.to_device(
        SyntheticLM(model.cfg, shape, seed=0).get_batch(0), dev)
    for remat in ("none", "attn_out"):
        plan = make_plan(model.cfg, shape, arch=ARCH, c=1, remat=remat)
        step_fn, sh = plan.build_train_step(model, adam)
        opt = adamw.init_state(sh["params"], adam)
        step_fn(opt, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step_fn(opt, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        emit("train_profile", remat=remat, seq_len=shape.seq_len, batch=1,
             max_memory_allocated=torch.cuda.max_memory_allocated(),
             card=smi, **_profile_window(prof, 1, wall, top=15))
        del step_fn, sh, opt, prof
        free_device()


# Steps 3-4 after a restart against the same steps run straight through:
# the restored state is the saved one to the bit and no kernel of the step
# uses atomics, so the losses are expected equal; 1e-5 relative allows for
# a library kernel that sums in another order.
RESUME_TOL = 1e-5


def phase_resume(dev, smi):
    """Checkpoint and restart at full width with the depth cut to 2
    layers (the checkpoint ~3 GB): 4 steps straight; 2 steps with
    ``ckpt_dir``; a model initialised otherwise resumed from that
    checkpoint to step 4. Bytes written, the in-loop ``ckpt_s``, and a
    restore and a blocking save of both trees timed alone."""
    import dataclasses
    import math
    import pathlib
    import tempfile

    import torch

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist import checkpoint
    from repro_torch.models.factory import build_model, jax_tree
    from repro_torch.optim import adamw
    from repro_torch.plan import make_plan
    from repro_torch.train import trainer

    cfg = dataclasses.replace(registry.get(ARCH), num_layers=2)
    shape = _train_shape(TRAIN_SEQ)
    plan = make_plan(cfg, shape, arch=ARCH, c=1)
    adam = adamw.AdamWConfig(learning_rate=1e-3, warmup_steps=0,
                             state_dtype=cfg.opt_dtype)
    data = SyntheticLM(cfg, shape, seed=0, seq_scheme=plan.seq_scheme,
                       sp_size=plan.sp_size)

    def run(seed, steps, ckpt_dir, path):
        model = build_model(cfg, device=dev, seed=seed)
        trainer.train(model, plan, adam, trainer.TrainerConfig(
            num_steps=steps, ckpt_every=2, ckpt_dir=ckpt_dir,
            log_every=steps, metrics_path=path), data_source=data,
            device=dev)
        with open(path) as f:
            return model, [json.loads(line) for line in f]

    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        ckpt = root / "ckpt"
        _, straight = run(0, 4, None, root / "straight.jsonl")
        t0 = time.perf_counter()
        _, first = run(0, 2, str(ckpt), root / "first.jsonl")
        first_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in ckpt.rglob("*")
                     if f.is_file())
        model, resumed = run(1, 4, str(ckpt), root / "resumed.jsonl")
        check([r["step"] for r in resumed] == [3, 4],
              f"resume: steps {[r['step'] for r in resumed]}, want [3, 4] "
              f"(restored from step 2)")
        rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
               for a, b in zip(resumed, straight[2:])]
        check(all(math.isfinite(x) and x <= RESUME_TOL for x in rel),
              f"resume: losses at steps 3-4 {[r['loss'] for r in resumed]} "
              f"vs straight {[r['loss'] for r in straight[2:]]}: rel {rel} "
              f"beyond {RESUME_TOL}")
        names = [n for n, _ in model.named_parameters()]
        like = jax_tree(dict(model.named_parameters()), cfg, "meta")
        opt_like = trainer.opt_tree(
            adamw.init_state([p.to("meta") for p in model.parameters()],
                             adam), names, cfg)
        t0 = time.perf_counter()
        trees = [checkpoint.restore(ckpt, 2, like),
                 checkpoint.restore(ckpt / "opt", 2, opt_like)]
        restore_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        checkpoint.save(root / "timing", 2, trees[0])
        checkpoint.save(root / "timing" / "opt", 2, trees[1])
        save_s = time.perf_counter() - t0
        del trees, model
    emit("resume", model=cfg.name, layers=cfg.num_layers,
         shape={"seq_len": shape.seq_len, "batch": shape.global_batch},
         remat=plan.remat, losses_straight=[r["loss"] for r in straight],
         losses_resumed={r["step"]: r["loss"] for r in resumed},
         loss_rel_diff=rel, tol=RESUME_TOL, checkpoint_bytes=nbytes,
         ckpt_s_in_loop=[r["ckpt_s"] for r in first if r["ckpt_s"]],
         first_run_s=first_s, restore_s=restore_s, blocking_save_s=save_s,
         card=smi)


# ---------------------------------------------------------------------------
# phase 13: training at SP degree 8 on a ThreadMesh on the card
# ---------------------------------------------------------------------------

TRAIN_SP_LAYERS, TRAIN_SP_STEPS = 8, 3
TRAIN_SP_C, TRAIN_SP_R = 2, 2                  # P = C * C * R = 8 ranks
# bf16 at P = 8 against P = 1 on the same weights and batch: the ranks sum
# their bf16 MLP and vocab partials in another order and the ring merges
# attention blocks in another order, so the first step's loss is held to
# 1e-2 absolute and its global gradient norm to 2% relative. In f32 (the
# CUDA-core kernels) the loss and every gradient leaf are held to 2e-3,
# the reference's ``check_spmd_model`` bound.
TRAIN_SP_TOL = {"loss_abs": 1e-2, "grad_norm_rel": 2e-2, "f32_abs": 2e-3}
TRAIN_SP_F32 = {"layers": 2, "seq_len": 1024}
TRAIN_SP_TIMEOUT = 180                         # s, a mesh run's limit


def _train_sp_parity(dev):
    """f32, depth 2, full width, seq 1024: the loss and every gradient
    leaf at P = 8 against P = 1 (also the first run of the mesh's backward
    on the card: a deadlock fails it within TRAIN_SP_TIMEOUT)."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist.comm import ThreadMesh
    from repro_torch.models.factory import build_model
    from repro_torch.plan import make_plan
    from repro_torch.train import step as train_step

    cfg = dataclasses.replace(registry.get(ARCH), param_dtype="float32",
                              num_layers=TRAIN_SP_F32["layers"])
    shape = _train_shape(TRAIN_SP_F32["seq_len"])
    model = build_model(cfg, device=dev, seed=1)
    plan = make_plan(cfg, shape, arch=ARCH, c=1)
    run_cfg = plan.run_config()
    vg1, _ = train_step.build_value_and_grad_fn(model, run_cfg, shape)
    loss1, g1 = vg1(train_step.to_device(
        SyntheticLM(cfg, shape, seed=2).get_batch(0), dev))
    p = TRAIN_SP_C * TRAIN_SP_C * TRAIN_SP_R
    vg8 = train_step.build_mesh_value_and_grad_fn(
        model, run_cfg, shape, ThreadMesh(TRAIN_SP_C, TRAIN_SP_R),
        timeout=TRAIN_SP_TIMEOUT)
    loss8, g8 = vg8(train_step.to_device(
        SyntheticLM(cfg, shape, seed=2, sp_size=p).get_batch(0), dev))
    names = [n for n, _ in model.named_parameters()]
    errs = {n: float((a - b).abs().max()) for n, a, b in zip(names, g8, g1)}
    worst = max(errs, key=errs.get)
    loss_err = abs(float(loss8) - float(loss1))
    check(all(torch.isfinite(g).all() for g in g8)
          and loss_err <= TRAIN_SP_TOL["f32_abs"]
          and errs[worst] <= TRAIN_SP_TOL["f32_abs"],
          f"train_sp f32: loss {float(loss8)} vs {float(loss1)}, worst "
          f"leaf {worst} max abs err {errs[worst]}, beyond "
          f"{TRAIN_SP_TOL['f32_abs']}")
    return dict(layers=cfg.num_layers, seq_len=shape.seq_len,
                loss={"P8": float(loss8), "P1": float(loss1)},
                loss_abs_err=loss_err, worst_leaf=worst,
                worst_leaf_max_abs_err=errs[worst], leaves=len(errs))


def phase_train_sp(dev, smi):
    """P = 8 ranks as ThreadMesh(c=2, r=2) threads on the one card train
    full-width h2o-danube-1.8b with the depth cut to 8 layers (P ranks'
    gradients share one card's memory, where a real job has P cards): seq
    4096, global batch 1, zigzag, ``remat='attn_out'``, bf16, through
    ``trainer.train`` on a plan with ``n_devices=8``; 3 AdamW steps on one
    repeated batch. The first step's loss and gradient norm against the
    same model at P = 1 on the same weights and batch; before it, the f32
    parity of ``_train_sp_parity``; after it, ``torch.profiler`` over one
    more step."""
    import dataclasses
    import math
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.factory import build_model
    from repro_torch.optim import adamw
    from repro_torch.plan import make_plan
    from repro_torch.train import step as train_step
    from repro_torch.train import trainer

    f32 = _train_sp_parity(dev)
    free_device()
    cfg = dataclasses.replace(registry.get(ARCH),
                              num_layers=TRAIN_SP_LAYERS)
    shape = _train_shape(TRAIN_SEQ)
    p = TRAIN_SP_C * TRAIN_SP_C * TRAIN_SP_R
    # placement and chunks pinned, not the ranking's pick, so the numbers
    # compare with the phase's earlier runs
    plan = make_plan(cfg, shape, arch=ARCH, n_devices=p, c=TRAIN_SP_C,
                     placement="team_inner", comm_chunks=1)
    check((plan.sp_size, plan.r, plan.remat, plan.seq_scheme)
          == (p, TRAIN_SP_R, "attn_out", "zigzag"),
          f"train_sp plan {plan}")
    model = build_model(cfg, device=dev, seed=0)
    adam = adamw.AdamWConfig(learning_rate=1e-3, warmup_steps=0,
                             state_dtype=cfg.opt_dtype)
    # the P = 1 reference: the same weights, the batch in natural order
    vg1, _ = train_step.build_value_and_grad_fn(model, plan.run_config(),
                                                shape)
    t0 = time.perf_counter()
    loss1, g1 = vg1(train_step.to_device(
        SyntheticLM(cfg, shape, seed=0).get_batch(0), dev))
    loss1, gnorm1 = float(loss1), float(adamw.global_norm(g1))
    p1_vg_s = time.perf_counter() - t0
    del g1
    free_device()
    data = RepeatBatch(SyntheticLM(cfg, shape, seed=0,
                                   seq_scheme=plan.seq_scheme,
                                   sp_size=plan.sp_size))
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train_sp_metrics.jsonl")
        counts = reset_counts()
        t0 = time.perf_counter()
        trainer.train(model, plan, adam, trainer.TrainerConfig(
            num_steps=TRAIN_SP_STEPS, log_every=TRAIN_SP_STEPS,
            metrics_path=path), data_source=data, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(counts)
        with open(path) as f:
            recs = [json.loads(line) for line in f]
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in recs]
    gnorms = [r["grad_norm"] for r in recs]
    check(len(recs) == TRAIN_SP_STEPS
          and all(math.isfinite(x) for x in losses + gnorms),
          f"train_sp losses {losses}: want {TRAIN_SP_STEPS} finite")
    check(losses[-1] < losses[0],
          f"train_sp loss did not fall over one repeated batch: {losses}")
    loss_err = abs(losses[0] - loss1)
    gnorm_rel = abs(gnorms[0] - gnorm1) / gnorm1
    check(loss_err <= TRAIN_SP_TOL["loss_abs"]
          and gnorm_rel <= TRAIN_SP_TOL["grad_norm_rel"],
          f"train_sp bf16 first step at P={p}: loss {losses[0]} vs P=1 "
          f"{loss1} (abs {loss_err}), grad norm {gnorms[0]} vs {gnorm1} "
          f"(rel {gnorm_rel}), beyond {TRAIN_SP_TOL}")
    L = cfg.num_layers
    per_step = launches_of(B2=p * plan.r * 2 * L, B3=p * plan.r * L)
    want = {k: v * TRAIN_SP_STEPS for k, v in per_step.items()}
    check(launches == want, f"train_sp launches {launches}: want {want} "
          f"(per step {per_step}: every rank's ring steps per layer, "
          f"forward twice under recompute and backward once)")
    step_ms = [1e3 * r["step_s"] for r in recs]
    # where the P = 8 step's time goes: one more step under the profiler
    step_fn, sh = plan.build_train_step(model, adam)
    opt = adamw.init_state(sh["params"], adam)
    batch = train_step.to_device(data.get_batch(0), dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(opt, batch)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    breakdown = _profile_window(prof, 1, prof_wall, top=10)
    del step_fn, sh, opt, prof
    emit("train_sp", model=cfg.name, layers=L, params=model.param_count(),
         weights="seeded random bf16",
         shape={"seq_len": shape.seq_len, "batch": shape.global_batch},
         plan={"n_devices": plan.n_devices, "P_sp": plan.sp_size,
               "C": plan.c, "R": plan.r, "data": plan.data,
               "seq_scheme": plan.seq_scheme, "remat": plan.remat,
               "block_impl": plan.block_impl},
         losses=losses, grad_norm=gnorms,
         p1_first_step={"loss": loss1, "grad_norm": gnorm1,
                        "value_and_grad_s": p1_vg_s},
         loss_abs_err=loss_err, grad_norm_rel_err=gnorm_rel,
         tol=TRAIN_SP_TOL, f32_parity=f32, step_ms=step_ms,
         wall_s=wall, max_memory_allocated=peak,
         launches_per_step=per_step, launches=launches,
         profile=breakdown, card=smi)
    del model
    return launches


# ---------------------------------------------------------------------------
# phase 14: the paper's baselines and StarTrail's chunked ring
# ---------------------------------------------------------------------------

SCHEMES_LAYERS, SCHEMES_STEPS = 8, 2
# (path name, scheme, C, comm_chunks); P = 8 ranks each
SCHEMES = (("ring", "ring", 1, 1), ("ulysses", "ulysses", 1, 1),
           ("startrail", "startrail", 2, 2))
# the profiled schemes (StarTrail at C = 2 is train_sp's profile)
SCHEMES_PROFILED = ("ring", "ulysses")


def _schemes_launches(name, plan, layers):
    """The plan's launches per step: every rank's ring steps per layer,
    forward twice under recompute and backward once; Ulysses one block per
    rank and layer, likewise."""
    p = plan.sp_size
    if name == "ulysses":
        return launches_of(B1=p * 2 * layers, B3=p * layers)
    return launches_of(B2=p * plan.r * 2 * layers, B3=p * plan.r * layers)


def phase_schemes(dev, smi):
    """The paper's comparison at full width: ``trainer.train`` on
    ``make_plan`` plans of P = 8 ThreadMesh ranks on the one card for the
    ring (C = 1, R = 8), DeepSpeed-Ulysses (all-to-all, B1 forward and B3
    backward over the whole sequence) and StarTrail (C = 2, R = 2, each ring
    transfer in 2 sub-chunks): h2o-danube-1.8b cut to 8 layers (as
    train_sp), seq 4096, batch 1, zigzag, ``remat='attn_out'``, bf16, 2
    AdamW steps each from the same weights on one repeated batch, with the
    obs registry and tracer on. Each first step's loss and gradient norm
    against P = 1 on the same weights and batch; exact launch counts from
    the plan; the forward island's ``comm_report`` per scheme (one layer at
    full width, seq 4096, bf16) must read 1.0 on every live kind. Printed
    beside them: the ledger's bytes per step against ``CommLog.per_step``,
    step ms, peak memory, and a profiled step of the ring and Ulysses."""
    import dataclasses
    import math
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.factory import build_model
    from repro_torch.obs import commlog
    from repro_torch.optim import adamw
    from repro_torch.plan import make_plan
    from repro_torch.train import step as train_step
    from repro_torch.train import trainer

    full = registry.get(ARCH)
    cfg = dataclasses.replace(full, num_layers=SCHEMES_LAYERS)
    shape = _train_shape(TRAIN_SEQ)
    p, L = ULYSSES_P, cfg.num_layers
    # the forward island of one attention layer per scheme
    reports = {}
    for name, scheme, c, chunks in SCHEMES:
        plan = make_plan(full, shape, arch=ARCH, n_devices=p, c=c,
                         scheme=scheme, placement="team_inner",
                         comm_chunks=chunks)
        rep = commlog.comm_report(full, plan, device=dev)
        rows = rep["per_collective"]
        live = {k: row for k, row in rows.items() if row["analytical_bytes"]}
        # a kind the scheme should not run at all must move no byte
        check(live and rep["ranks_agree"] and rep["within_tolerance"]
              and all(row["ratio"] == 1.0 for row in live.values())
              and all(row["measured_bytes"] == 0 for k, row in rows.items()
                      if k not in live),
              f"schemes {name}: comm_report {rows} (ranks agree: "
              f"{rep['ranks_agree']}): every live kind must read 1.0 and "
              f"every other kind 0 bytes")
        reports[name] = {
            "per_collective": {k: {"measured_bytes": row["measured_bytes"],
                                   "analytical_bytes":
                                       row["analytical_bytes"],
                                   "eqs_bytes": row["eqs_bytes"],
                                   "ratio": row["ratio"]}
                               for k, row in rows.items()
                               if k in live or row["eqs_bytes"]},
            "unmodelled_allreduce_bytes": rep["unmodelled_allreduce_bytes"],
            "collective_counts": rep["collective_counts"]}
    free_device()

    model = build_model(cfg, device=dev, seed=0)
    init = [t.detach().clone() for t in model.parameters()]
    adam = adamw.AdamWConfig(learning_rate=1e-3, warmup_steps=0,
                             state_dtype=cfg.opt_dtype)
    # the P = 1 reference: the same weights, the batch in natural order
    plan1 = make_plan(cfg, shape, arch=ARCH, c=1)
    vg1, _ = train_step.build_value_and_grad_fn(model, plan1.run_config(),
                                                shape)
    loss1, g1 = vg1(train_step.to_device(
        SyntheticLM(cfg, shape, seed=0).get_batch(0), dev))
    loss1, gnorm1 = float(loss1), float(adamw.global_norm(g1))
    del g1, vg1
    free_device()
    data = RepeatBatch(SyntheticLM(cfg, shape, seed=0, seq_scheme="zigzag",
                                   sp_size=p))
    by_path, out = {}, {}
    for name, scheme, c, chunks in SCHEMES:
        with torch.no_grad():
            for t, t0 in zip(model.parameters(), init):
                t.copy_(t0)
        plan = make_plan(cfg, shape, arch=ARCH, n_devices=p, c=c,
                         scheme=scheme, placement="team_inner",
                         comm_chunks=chunks)
        check((plan.sp_size, plan.c, plan.comm_chunks, plan.remat,
               plan.seq_scheme) == (p, c, chunks, "attn_out", "zigzag"),
              f"schemes {name} plan {plan}")
        reg, tracer = obs.Registry(), obs.Tracer(enabled=True)
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "metrics.jsonl")
            counts = reset_counts()
            t0 = time.perf_counter()
            trainer.train(model, plan, adam, trainer.TrainerConfig(
                num_steps=SCHEMES_STEPS, log_every=SCHEMES_STEPS,
                metrics_path=path), data_source=data, device=dev,
                tracer=tracer, registry=reg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counts(counts)
            with open(path) as f:
                recs = [json.loads(line) for line in f]
        peak = torch.cuda.max_memory_allocated()
        losses = [r["loss"] for r in recs]
        gnorms = [r["grad_norm"] for r in recs]
        check(len(recs) == SCHEMES_STEPS
              and all(math.isfinite(x) for x in losses + gnorms)
              and losses[-1] < losses[0],
              f"schemes {name}: losses {losses} must be finite and fall")
        loss_err = abs(losses[0] - loss1)
        gnorm_rel = abs(gnorms[0] - gnorm1) / gnorm1
        check(loss_err <= TRAIN_SP_TOL["loss_abs"]
              and gnorm_rel <= TRAIN_SP_TOL["grad_norm_rel"],
              f"schemes {name} first step at P={p}: loss {losses[0]} vs "
              f"P=1 {loss1} (abs {loss_err}), grad norm {gnorms[0]} vs "
              f"{gnorm1} (rel {gnorm_rel}), beyond {TRAIN_SP_TOL}")
        per_step = _schemes_launches(name, plan, L)
        want = {k: v * SCHEMES_STEPS for k, v in per_step.items()}
        check(launches == want, f"schemes {name} launches {launches}: want "
              f"{want} (per step {per_step}, from the plan)")
        spans = [e["name"] for e in tracer.events()]
        check(spans.count("train/step") == SCHEMES_STEPS,
              f"schemes {name}: tracer spans {spans}")
        measured = {}
        for (fam, key), v in obs.parse_prometheus(
                reg.render_prometheus()).items():
            if fam == "comm_ledger_bytes_total":
                lab = dict(key)
                measured.setdefault(lab["pass"], {})[lab["collective"]] = \
                    v / SCHEMES_STEPS
        log = commlog.CommLog(obs.Registry(), cfg, plan)
        row = dict(plan={"scheme": plan.scheme, "C": plan.c, "R": plan.r,
                         "P_sp": plan.sp_size,
                         "comm_chunks": plan.comm_chunks},
                   losses=losses, grad_norm=gnorms,
                   loss_abs_err=loss_err, grad_norm_rel_err=gnorm_rel,
                   step_ms=[1e3 * r["step_s"] for r in recs], wall_s=wall,
                   max_memory_allocated=peak, launches_per_step=per_step,
                   launches=launches,
                   ledger_bytes_per_step=measured,
                   commlog_per_step=log.per_step,
                   island=reports[name])
        if name in SCHEMES_PROFILED:
            step_fn, sh = plan.build_train_step(model, adam)
            opt = adamw.init_state(sh["params"], adam)
            batch = train_step.to_device(data.get_batch(0), dev)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step_fn(opt, batch)
                torch.cuda.synchronize()
                prof_wall = time.perf_counter() - t0
            row["profile"] = _profile_window(prof, 1, prof_wall, top=10)
            del step_fn, sh, opt, prof, batch
        out[name] = row
        by_path[f"schemes_{name}"] = launches
        free_device()
    emit("schemes", model=cfg.name, layers=L, params=model.param_count(),
         weights="seeded random bf16",
         shape={"seq_len": shape.seq_len, "batch": shape.global_batch},
         remat="attn_out", steps=SCHEMES_STEPS,
         p1_first_step={"loss": loss1, "grad_norm": gnorm1},
         tol=TRAIN_SP_TOL,
         island_shape={"layers": 1, "seq_len": TRAIN_SEQ, "batch": 1,
                       "dtype": "bfloat16", "heads": [full.num_heads,
                                                      full.num_kv_heads],
                       "head_dim": full.head_dim_},
         schemes=out, card=smi)
    del model, init
    return by_path


# ---------------------------------------------------------------------------
# phase 15: the §3.4 topology scheduler, measured
# ---------------------------------------------------------------------------

AUTOTUNE = {"top_k": 3, "steps": 2, "warmup": 1}


@contextlib.contextmanager
def _registry_depth(layers):
    """``registry.get`` with the depth cut to ``layers`` (the launcher
    builds its model from the registry; P = 8 ranks' gradients of 24
    layers would crowd one card, as in train_sp)."""
    import dataclasses

    from repro_torch.configs import registry

    get = registry.get
    registry.get = lambda name: dataclasses.replace(get(name),
                                                    num_layers=layers)
    try:
        yield
    finally:
        registry.get = get


def phase_autotune(dev, smi):
    """The paper's §3.4 procedure end to end: the analytical ranking of
    every legal arrangement at P = 8 under the H100 table
    (``roofline.hw``), then ``plan.autotune.autotune`` (top 3 plus the
    analytical worst: at P = 8 all four arrangements) times each on
    ``trainer``'s step (warm-up 1, 2 timed steps, P = 8 ThreadMesh ranks on
    the one card) at the schemes phase's size (h2o-danube-1.8b cut to 8
    layers, seq 4096, batch 1, bf16, ``attn_out``), every candidate from
    the same seeded weights. The winner's plan file must reload equal and
    hold the arrangement its own record timed fastest, ``launch.train
    --plan FILE --steps 1`` must train one finite step from it through B2
    and B3 (B1 and B3 if Ulysses won), and
    ``make_serve_plan(c=None)`` on the full model must give C = 1 at
    P = 1. One card's ranks exchange synchronously and the step is
    host-bound, so the measured order ranks host and kernel time, not
    wires; the analytical one is the prediction a multi-card cell tests."""
    import dataclasses
    import math
    import pathlib
    import tempfile

    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import train as launch_train
    from repro_torch.plan import ExecutionPlan, autotune, cost
    from repro_torch.plan import make_serve_plan

    full = registry.get(ARCH)
    cfg = dataclasses.replace(full, num_layers=SCHEMES_LAYERS)
    shape = _train_shape(TRAIN_SEQ)
    p, L = ULYSSES_P, cfg.num_layers
    ranking = cost.rank_arrangements(cfg, shape, p)
    want_keys = ({e["arrangement"].key for e in ranking[:AUTOTUNE["top_k"]]}
                 | {ranking[-1]["arrangement"].key})
    with tempfile.TemporaryDirectory() as tmp:
        counts = reset_counts()
        t0 = time.perf_counter()
        tuned = autotune.autotune(
            cfg, shape, arch=ARCH, n_devices=p, top_k=AUTOTUNE["top_k"],
            steps=AUTOTUNE["steps"], warmup=AUTOTUNE["warmup"],
            out_dir=tmp, device=dev)
        torch.cuda.synchronize()
        search_s = time.perf_counter() - t0
        search = read_counts(counts)
        measured = tuned["measured"]
        keys = [e["arrangement"].key for e in measured]
        check(sorted(keys) == sorted(want_keys),
              f"autotune measured {keys}: want the analytical top "
              f"{AUTOTUNE['top_k']} and the worst, {sorted(want_keys)}")
        times = [e["measured_s"] for e in measured]
        check(all(math.isfinite(t) and t > 0 for t in times),
              f"autotune times {dict(zip(keys, times))}")
        per_run = AUTOTUNE["warmup"] + AUTOTUNE["steps"]
        want = launches_of()
        for e in measured:
            for k, v in _schemes_launches(e["plan"].scheme, e["plan"],
                                          L).items():
                want[k] += v * per_run
        check(search == want, f"autotune search launches {search}: want "
              f"{want} ({per_run} steps per candidate, from each plan)")
        winner = ExecutionPlan.load(tuned["path"])
        check(winner == tuned["plan"], f"plan file {tuned['path']} "
              f"reloads as {winner}, not {tuned['plan']}")
        # the file's own record: its plan is the arrangement it timed fastest
        filed = json.loads(pathlib.Path(tuned["path"]).read_text())
        fastest = min(filed["measured"], key=lambda m: m["measured_s"])
        won = cost.Arrangement(winner.scheme, winner.c, winner.r,
                               winner.placement).key
        check(fastest["arrangement"] == won,
              f"plan file holds {won}, but its fastest measured "
              f"arrangement is {fastest['arrangement']} of "
              f"{filed['measured']}")
        free_device()
        counts = reset_counts()
        t0 = time.perf_counter()
        with _registry_depth(SCHEMES_LAYERS):
            out = launch_train.main(["--plan", str(tuned["path"]),
                                     "--steps", "1", "--device", dev.type])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        trained = read_counts(counts)
    want = _schemes_launches(winner.scheme, winner, L)
    check(out["step"] == 1 and math.isfinite(out["loss"])
          and trained == want,
          f"launch.train --plan: step {out['step']} loss {out['loss']}, "
          f"launches {trained}: want one finite step and {want}")
    serve = make_serve_plan(full, arch=ARCH)
    check((serve.sp_size, serve.c) == (1, 1),
          f"make_serve_plan(c=None) gave P={serve.sp_size} C={serve.c}")
    emit("autotune", model=cfg.name, layers=L,
         shape={"seq_len": shape.seq_len, "batch": shape.global_batch},
         P=p, hw=hw_table(), card=smi,
         analytical=[{"arrangement": e["arrangement"].key,
                      "us_per_layer": 1e6 * e["total_s"],
                      "model_s": e["model_s"], "volumes": e["volumes"]}
                     for e in ranking],
         measured=[{"arrangement": e["arrangement"].key,
                    "measured_s_per_step": e["measured_s"],
                    "analytical_s_per_layer": e["analytical_s"],
                    "analytical_model_s": e["analytical_s"] * L}
                   for e in measured],
         winner=winner.to_dict(), search_s=search_s, **AUTOTUNE,
         launches=search, plan_step={"loss": out["loss"], "wall_s": train_s,
                                     "launches": trained},
         serve_plan={"P_sp": serve.sp_size, "C": serve.c,
                     "scheme": serve.scheme})
    return {"autotune": search, "autotune_plan": trained}


# ---------------------------------------------------------------------------
# phases 16-17: the dense configs at head size 128
# ---------------------------------------------------------------------------

DENSE_ARCH = "minitron-8b"
DENSE_PLENS = [64, 200, 336, 472, 608, 744, 880, 1024]   # P = 1 prompts
DENSE_NEW = 32
# P = 8: 4 of the P = 1 prompts (336-1024 tokens), 8 new tokens each; then
# 2 prompts sharing a 512-token prefix through 256-token chunks
DENSE_P8 = {"n_devices": 8, "c": 2, "prompts": (2, 4, 6, 7),
            "new_tokens": 8, "prefix": 512, "chunk": 256,
            "suffixes": (128, 256)}
# P = 8 sampled: prompt 2 greedy and prompt 4 sampled, 8 new tokens each
DENSE_P8_SAMPLED = {"greedy": 2, "sampled": 4, "temperature": 0.8,
                    "top_k": 40, "top_p": 0.9, "seed": 7}
# P = 8 rounds in bf16 where P = 1 does not: the MLP's reduce-scatter sums
# 8 bf16 partial products, the embedding's psum 8 partial lookups, and the
# ring merges 2 blocks per team before the team's combine. Over 32 layers
# that is a few bf16 roundings per layer more than ENGINE_TOL's 24-layer
# budget covers, so P = 8 against P = 1 gets 5e-2 relative in the L2 norm
# and 1e-1 of the largest magnitude: a wrong merge or kernel is off by O(1).
DENSE_SP_TOL = {"rel_l2": 5e-2, "max_abs_over_max": 1e-1}


def _dense_engine(model, n_devices=1, c=1, prefix_cache=False, chunk=0):
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.plan import make_serve_plan

    plan = make_serve_plan(model.cfg, arch=DENSE_ARCH, n_devices=n_devices,
                           c=c, decode_batch=4, page_size=16, max_len=2048,
                           prefix_cache=prefix_cache)
    # 4 slots of 2048 tokens in pages of 16, spread over the SP ranks
    return Engine(model, plan, EngineConfig(
        pages_per_shard=512 // plan.sp_size, prefill_chunk=chunk))


def phase_dense_serve(dev, smi):
    """The engine at the full width of minitron-8b (32 layers, d_model
    4096, 32q/8kv heads of 128, vocab 256000, ~9.9 B seeded bf16
    parameters): at P = 1, 8 greedy requests of 64-1024 prompt tokens and
    32 new tokens (B2 per layer and prefill, B4 per layer and decode step);
    then at P = 8 as ThreadMesh(c=2, r=2) threads on the one card from the
    same weights, cut to 4 of those prompts (336-1024 tokens) with 8 new
    tokens each (B2 on every rank, ring step and layer of a prefill; B4 on
    every rank and layer of a decode step), and 2 prompts sharing a
    512-token prefix through the prefix cache and 256-token chunks (each
    suffix chunk runs B6 and B1 on every rank and layer, merged across the
    ranks). The P = 8 cut keeps the phase near 150 s: its 8 rank threads
    share the GIL, so a step takes seconds. Each request's first-token
    hidden state at P = 8 is held against P = 1's (``DENSE_SP_TOL``); the
    share of streamed tokens that agree with P = 1's is printed (a
    mismatch after a bf16 near tie is reported, not failed on)."""
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.engine import Request
    from repro_torch.models.factory import build_model

    cfg = registry.get(DENSE_ARCH)
    L = cfg.num_layers
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in DENSE_PLENS]
    e1 = _dense_engine(model)
    e1.add_request(Request("warm", prompts[0], 4))
    e1.run()
    e1.reset()
    reqs = [Request(f"d{i}", p, DENSE_NEW) for i, p in enumerate(prompts)]
    out1, hid1, l1, rec1 = drive_engine(e1, smi, reqs, p1_launches,
                                        "dense P=1", profile_steps=4)

    sp, c = DENSE_P8["n_devices"], DENSE_P8["c"]
    e8 = _dense_engine(model, sp, c)
    check(not e8.plan.block_skip, "dense P=8: ring-block skipping is on, "
          "the launch counts below assume every ring step runs")
    ring = e8.plan.r
    n8 = DENSE_P8["new_tokens"]
    reqs8 = [Request(f"d{i}", prompts[i], n8) for i in DENSE_P8["prompts"]]

    def p8_launches(e):
        # B2 on every rank, ring step and layer of a prefill; B4 on every
        # rank and layer of a decode step
        return launches_of(B2=sp * ring * L * e.metrics.prefills,
                           B4=sp * L * e.metrics.decode_steps)

    out8, hid8, l8, rec8 = drive_engine(e8, smi, reqs8, p8_launches,
                                        "dense P=8", profile_steps=1)
    errs, agree, total = {}, 0, 0
    for r in reqs8:
        toks = out8[r.uid]
        errs[r.uid] = compare(
            (hid8[r.uid], _logits(e1, hid8[r.uid])),
            (hid1[r.uid], _logits(e1, hid1[r.uid])),
            f"dense P=8 {r.uid} vs P=1", DENSE_SP_TOL)
        agree += sum(a == b for a, b in zip(toks, out1[r.uid][:n8]))
        total += n8

    # one sampled and one greedy request at P = 8: every rank samples (the
    # engine raises if their tokens differ), the sampled stream equals its
    # solo run, the greedy one its stream in the all-greedy run above (its
    # batch invariance)
    ps = DENSE_P8_SAMPLED
    greq = Request(f"d{ps['greedy']}", prompts[ps["greedy"]], n8)
    sreq = Request(f"d{ps['sampled']}s", prompts[ps["sampled"]], n8,
                   temperature=ps["temperature"], top_k=ps["top_k"],
                   top_p=ps["top_p"], seed=ps["seed"])
    e8.reset()
    outs, _, ls, recs = drive_engine(e8, smi, [greq, sreq], p8_launches,
                                     "dense P=8 sampled")
    check(outs[greq.uid] == out8[greq.uid], f"dense P=8 sampled: greedy "
          f"{greq.uid} {outs[greq.uid]} beside a sampled request, "
          f"{out8[greq.uid]} in the all-greedy run")
    solo, walls8 = solo_streams(e8, [sreq])
    check(solo[sreq.uid] == outs[sreq.uid], f"dense P=8 sampled: alone "
          f"{solo[sreq.uid]}, beside a greedy request {outs[sreq.uid]}")
    del e8
    free_device()

    # the prefix cache and chunked prefill at P = 8
    ep = _dense_engine(model, sp, c, prefix_cache=True,
                       chunk=DENSE_P8["chunk"])
    shared = rng.integers(0, cfg.vocab_size, DENSE_P8["prefix"]).tolist()
    reqp = [Request(f"px{i}", shared + rng.integers(
        0, cfg.vocab_size, n).tolist(), n8)
        for i, n in enumerate(DENSE_P8["suffixes"])]

    def prefix_launches(e):
        # a prompt with nothing cached runs its leading chunk through B2;
        # every later chunk, and a cache hit's suffix, runs B6 and B1 on
        # every rank and layer
        m = e.metrics
        leading = sum(1 for st in e.scheduler.finished.values()
                      if st.cached_len == 0)
        suffix = m.prefill_chunks - leading
        return launches_of(B2=sp * ring * L * leading, B1=sp * L * suffix,
                           B6=sp * L * suffix, B4=sp * L * m.decode_steps)

    outp, hidp, lp, recp = drive_engine(ep, smi, reqp[:1], prefix_launches,
                                        "dense P=8 prefix", later=reqp[1:])
    cached = {r.uid: ep.scheduler.finished[r.uid].cached_len for r in reqp}
    check(cached[reqp[1].uid] == DENSE_P8["prefix"],
          f"dense P=8 prefix: cached lengths {cached}, want the second "
          f"request's {DENSE_P8['prefix']}-token prefix cached")
    for r in reqp:
        toks = outp[r.uid]
        mono = next_token(e1, r.tokens)
        errs[r.uid] = compare((hidp[r.uid], _logits(e1, hidp[r.uid])), mono,
                              f"dense P=8 {r.uid} vs P=1 monolithic",
                              DENSE_SP_TOL)
        agree += int(toks[0] == int(mono[1].argmax()))
        total += 1
    worst = {k: max(e[name][k] for e in errs.values()
                    for name in ("hidden", "logits")) for k in DENSE_SP_TOL}
    emit("dense_serve", model=cfg.name, params=model.param_count(),
         weights="seeded random bf16", init_s=init_s,
         p1={"prompt_lens": DENSE_PLENS, "new_tokens": DENSE_NEW, **rec1},
         p8={"prompt_lens": [DENSE_PLENS[i] for i in DENSE_P8["prompts"]],
             "new_tokens": n8, **rec8},
         p8_sampled={**ps, "prompt_lens": [DENSE_PLENS[ps["greedy"]],
                                           DENSE_PLENS[ps["sampled"]]],
                     "new_tokens": n8, "streams": outs,
                     "sampled_solo_equal": True,
                     "sampled_solo_decode_step_wall_ms_median": _median_ms(
                         walls8, lambda u, s: True), **recs},
         p8_prefix={"prefix_len": DENSE_P8["prefix"],
                    "suffix_lens": list(DENSE_P8["suffixes"]),
                    "chunk": DENSE_P8["chunk"], "cached_len": cached,
                    **recp},
         err_p8_vs_p1=errs, worst_err=worst, tol=DENSE_SP_TOL,
         tokens_agreeing_with_p1=agree / total, tokens_compared=total)
    del e1, ep, model
    return {"dense_serve_p1": l1, "dense_serve_p8": l8,
            "dense_serve_p8_sampled": ls, "dense_serve_p8_prefix": lp}


DENSE_TRAIN = {"model": "gpt-7b", "layers": 8, "seq": 4096, "steps": 3}
# bytes a parameter holds while training: bf16 weights and gradients, f32
# AdamW moments (the activations aside)
TRAIN_BYTES_PER_PARAM = 2 + 2 + 8


def _spec_params(tree):
    """Parameters a spec tree declares, counted without allocating."""
    import math

    from repro_torch.models.spec import PSpec

    if isinstance(tree, PSpec):
        return math.prod(tree.shape)
    items = tree.values() if isinstance(tree, dict) else tree
    return sum(_spec_params(t) for t in items)


def phase_dense_train(dev, smi):
    """``trainer.train`` on the paper's GPT-7B (MHA 32/32, head size 128,
    d_ff 16384, vocab 50304) at seq 4096, batch 1, ``remat='attn_out'``,
    bf16, 3 AdamW steps on one repeated batch, at P = 1. The depth is cut
    from 32 to 8 layers: the reckoned bytes of weights, gradients and
    moments are printed for both. B2 runs 2 x 8 and B3 8 times a step.
    Then the D = 128 backward's device time from a profiled step, and one
    loss and gradient at seq 1024 under the CUDA kernels against the plain
    versions (``TRAIN_CHECK_TOL``)."""
    import dataclasses
    import math
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer
    from repro_torch.models.factory import build_model
    from repro_torch.optim import adamw
    from repro_torch.plan import make_plan
    from repro_torch.train import step as train_step
    from repro_torch.train import trainer

    full = registry.paper_model(DENSE_TRAIN["model"])
    L = DENSE_TRAIN["layers"]
    cfg = dataclasses.replace(full, num_layers=L)
    reckoned = {n: _spec_params(transformer.lm_specs(dataclasses.replace(
        full, num_layers=n))) * TRAIN_BYTES_PER_PARAM
        for n in (full.num_layers, L)}
    shape = _train_shape(DENSE_TRAIN["seq"])
    plan = make_plan(cfg, shape, arch=full.name, c=1)
    check(plan.remat == "attn_out", f"plan remat {plan.remat!r}")
    model = build_model(cfg, device=dev, seed=0)
    adam = adamw.AdamWConfig(learning_rate=1e-3, warmup_steps=0,
                             state_dtype=cfg.opt_dtype)
    data = RepeatBatch(SyntheticLM(cfg, shape, seed=0,
                                   seq_scheme=plan.seq_scheme,
                                   sp_size=plan.sp_size))
    steps = DENSE_TRAIN["steps"]
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dense_train.jsonl")
        counts = reset_counts()
        t0 = time.perf_counter()
        trainer.train(model, plan, adam, trainer.TrainerConfig(
            num_steps=steps, log_every=steps, metrics_path=path),
            data_source=data, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(counts)
        with open(path) as f:
            recs = [json.loads(line) for line in f]
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in recs]
    check(len(recs) == steps and all(math.isfinite(x) for x in losses),
          f"dense_train losses {losses}: want {steps} finite")
    check(losses[-1] < losses[0],
          f"dense_train loss did not fall over one repeated batch: {losses}")
    want = launches_of(B2=2 * L * steps, B3=L * steps)
    check(launches == want, f"dense_train launches {launches}: want {want}")
    free_device()
    # one profiled step after one warm step: the D = 128 backward kernels
    step_fn, sh = plan.build_train_step(model, adam)
    opt = adamw.init_state(sh["params"], adam)
    batch = train_step.to_device(data.get_batch(0), dev)
    step_fn(opt, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(opt, batch)
        torch.cuda.synchronize()
        step_wall = time.perf_counter() - t0
    bwd = {"dkv": [0.0, 0], "dq": [0.0, 0]}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for key, tag in (("dkv", "flash_bwd_dkv_mma"),
                         ("dq", "flash_bwd_dq_mma")):
            if tag in evt.name:
                bwd[key][0] += evt.time_range.elapsed_us() / 1e3
                bwd[key][1] += 1
    check(bwd["dkv"][1] == L and bwd["dq"][1] == L,
          f"dense_train profile: B3's kernels ran {bwd}, want {L} each")
    window = _profile_window(prof, 1, step_wall, top=12)
    del step_fn, sh, opt, prof, batch
    free_device()
    emit("dense_train", model=full.name, layers=L,
         layers_published=full.num_layers, params=model.param_count(),
         weights="seeded random bf16",
         reckoned_bytes={f"{n}_layers": b for n, b in reckoned.items()},
         reckoned_bytes_note="bf16 weights and gradients, f32 AdamW "
                             "moments: 12 B a parameter, activations aside",
         shape={"seq_len": shape.seq_len, "batch": shape.global_batch},
         plan={"P_sp": plan.sp_size, "C": plan.c, "scheme": plan.scheme,
               "remat": plan.remat, "block_impl": plan.block_impl},
         losses=losses, grad_norm=[r["grad_norm"] for r in recs],
         step_ms=[1e3 * r["step_s"] for r in recs], wall_s=wall,
         max_memory_allocated=peak, launches=launches,
         b3_d128_device_ms={k: {"ms_per_step": v[0], "calls": v[1],
                                "ms_per_call": v[0] / max(v[1], 1)}
                            for k, v in bwd.items()},
         profile=window, card=smi)
    phase_train_check(model, dev, phase="dense_train_check")
    del model
    return launches


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
             total_memory=torch.cuda.get_device_properties(0).total_memory,
             torch=torch.__version__, cuda=torch.version.cuda)
        info = _build.build_info()
        emit("build", seconds=info["seconds"], built=info["built"],
             ptxas=info["ptxas"], hw=hw_table(), card=smi)
        rows = phase_kernels(dev)
        free_device()
        phase_kernels_ulysses(dev, rows)
        free_device()
        phase_kernels_d128(dev, rows)
        free_device()
        by_path = {"ring": phase_ring(dev)}
        free_device()
        by_path["ragged_bwd"] = phase_ragged_bwd(dev)
        free_device()
        (by_path["engine"], by_path["sample"], by_path["local"],
         by_path["prefix"], by_path["legacy"]) = serving_phases(dev, smi)
        free_device()
        model, by_path["train"] = phase_train(dev, smi)
        free_device()
        phase_train_check(model, dev)
        free_device()
        phase_train_profile(model, dev, smi)
        del model
        free_device()
        phase_resume(dev, smi)
        free_device()
        by_path["train_sp"] = phase_train_sp(dev, smi)
        free_device()
        by_path.update(phase_schemes(dev, smi))
        free_device()
        by_path.update(phase_autotune(dev, smi))
        free_device()
        by_path.update(phase_dense_serve(dev, smi))
        free_device()
        by_path["dense_train"] = phase_dense_train(dev, smi)
        paths = {"B1": "local", "B2": "engine", "B3": "train",
                 "B4": "engine", "B5": "legacy", "B6": "prefix",
                 "B7": "ragged_bwd"}
        for name, row in rows.items():
            row["launches"] = by_path[paths[name]][name]
            row["launches_by_path"] = {k: v[name] for k, v in by_path.items()}
            check(row["launches"] > 0, f"{name} never launched on its path")
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        return 1
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "tol", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "device_ms",
            "library_device_ms", "d128")
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
