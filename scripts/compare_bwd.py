#!/usr/bin/env python3
"""Time and check the bf16 flash backward (B3, B7) of one or more checkouts
of this repository on one CUDA card, each in its own process, in the order
given (repeat a path to run it in turns: parent, change, change, parent).

    python3 scripts/compare_bwd.py ROOT [ROOT ...]

For each ROOT (a directory holding ``chip_smoke.py`` and
``src/repro_torch``) one JSON line: the ptxas registers and spills of its
bf16 backward kernels (``--ptxas``, the first time a ROOT appears), its
CTAs per SM where the checkout can report them, and, against its own plain
versions, B3 at seq 4096 (q (1,4096,32,80), k/v (1,4096,8,80), causal),
B7 at ``chip_smoke.py``'s ``path_4x1024`` shape, and B3 on one 12288-token
block of 4 query heads over one kv head: the largest absolute error, the
largest error over (1 + |reference|) (what the 3e-4 check bounds), whether
two runs give the same bits, and the milliseconds per call (CUDA events,
``chip_smoke.time_ms``). The card's name and power limit come first.
"""

import json
import os
import subprocess
import sys

LONG_SEQ = 12288


def _errs(got, want):
    return dict(
        abs=max(float((a - b).abs().max()) for a, b in zip(got, want)),
        scaled=max(float(((a - b).abs() / (1 + b.abs())).max())
                   for a, b in zip(got, want)))


def _b3_inputs(dev, S, hq, hkv, seed=3):
    import torch

    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((1, S, hq, 80), generator=g, device=dev).bfloat16()
    k = torch.randn((1, S, hkv, 80), generator=g, device=dev).bfloat16()
    v = torch.randn((1, S, hkv, 80), generator=g, device=dev).bfloat16()
    do = torch.randn((1, S, hq, 80), generator=g, device=dev).bfloat16()
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    o, lse = fa.flash_attention_fwd_plain(q, k, v, pos, pos, window=S)
    delta = torch.einsum("bshd,bshd->bhs", do.float(),
                         o.bfloat16().float()).contiguous()
    return q, k, v, do, lse, delta, pos, pos


def one(root, ptxas):
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ragged_bwd as rb

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"root": root}
    if ptxas:
        out["ptxas"] = [line for line in _build.build_info()["ptxas"]
                        if "_mma" in line and "flash_bwd_cu" in line]
    if hasattr(fa, "bwd_occupancy"):
        out["occupancy_d80_seq4096"] = fa.bwd_occupancy(80, 4096, 4096)

    bargs = _b3_inputs(dev, 4096, 32, 8)
    got = fa.flash_attention_bwd(*bargs, window=4096)
    want = fa.flash_attention_bwd_plain(*bargs, window=4096)
    again = fa.flash_attention_bwd(*bargs, window=4096)
    out["B3_seq4096"] = dict(
        _errs(got, want),
        same_bits=all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
        ms=cs.time_ms(lambda: fa.flash_attention_bwd(*bargs, window=4096),
                      reps=10, inner=2))
    del bargs, got, want, again
    torch.cuda.empty_cache()

    b, sq, sk, hq, hkv, window, offs, zero = \
        cs.ragged_bwd_cases()["path_4x1024"]
    args7 = cs.ragged_bwd_inputs(dev, torch.bfloat16, b, sq, sk, hq, hkv,
                                 window, offs, zero)
    got = rb.flash_attention_bwd_ragged(*args7, window=window)
    want = rb.flash_attention_bwd_ragged_plain(*args7, window=window)
    out["B7_path_4x1024"] = dict(_errs(got, want), ms=cs.time_ms(
        lambda: rb.flash_attention_bwd_ragged(*args7, window=window),
        reps=10, inner=2))
    del args7, got, want
    torch.cuda.empty_cache()

    largs = _b3_inputs(dev, LONG_SEQ, 4, 1)
    got = fa.flash_attention_bwd(*largs, window=LONG_SEQ)
    want = fa.flash_attention_bwd_plain(*largs, window=LONG_SEQ)
    out[f"B3_seq{LONG_SEQ}_4q1kv"] = _errs(got, want)
    print(json.dumps(out), flush=True)


def main(argv):
    if argv[:1] == ["--one"]:
        one(argv[1], "--ptxas" in argv)
        return 0
    roots = argv or ["."]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    seen, rc = set(), 0
    for root in roots:
        cmd = [sys.executable, os.path.abspath(__file__), "--one", root]
        if root not in seen:
            cmd.append("--ptxas")
        seen.add(root)
        rc = subprocess.run(cmd, timeout=600).returncode or rc
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
