#!/usr/bin/env python3
"""Time and check the bf16 flash forward (B1, B2, B5) of one or more
checkouts of this repository on one CUDA card, each in its own process, in
the order given (repeat a path to run it in turns: parent, change, change,
parent).

    python3 scripts/compare_fwd.py ROOT [ROOT ...]

For each ROOT (a directory holding ``chip_smoke.py`` and
``src/repro_torch``) one JSON line: the ptxas registers and spills of its
bf16 forward kernels (the first time a ROOT appears), its CTAs per SM where
the checkout can report them, and, at ``chip_smoke.py``'s timing shapes
(B1: q (1,1024,32,80), k/v (1,1024,8,80), causal; B2: the same at seq
4096 with a running accumulator; B5: the legacy decode shape, q (4,1,32,80)
against k/v (4,1056,8,80)), each kernel's largest error against its plain
version and its milliseconds per call from CUDA events around bursts
(``chip_smoke.time_ms``: paced by the host when a call is shorter than
its Python wrapper) and from the device alone (``chip_smoke.device_ms``:
calls queued behind a device sleep), each taken twice in turns (a, b, b,
a) in two layouts: ``packed``, the model's 8 kv heads for 32 query heads,
and ``per_head``, the same K/V repeated to 32 kv heads (G = 1), so that
every CTA holds the rows of one head and reads its own copy of K/V, as a
per-head tile does. Beside them, SDPA's time at the B1 and B2 shapes
(is_causal, enable_gqa; o only). The card's name and power limit come
first.
"""

import json
import os
import subprocess
import sys


def _err(got, want):
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def one(root, ptxas):
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ragged_prefill as rp

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"root": root}
    if ptxas:
        out["ptxas"] = [line for line in _build.build_info()["ptxas"]
                        if "flash_fwd" in line and "flash_fwd_cu" in line
                        and "ILi80E" in line]
    if hasattr(fa, "fwd_occupancy"):
        try:
            out["occupancy_d80"] = {
                "seq4096": fa.fwd_occupancy(80, 4096, 4096, 4),
                "decode_sq1_sk1056": fa.fwd_occupancy(80, 1, 1056, 4)}
        except TypeError:            # an entry of another signature
            pass

    def bench(name, fn, plain, args, kv, reps, inner):
        """fn against plain on ``args`` with K/V packed and repeated to one
        kv head per query head, timed a, b, b, a."""
        g = args[0].shape[2] // args[1].shape[2]
        rep = list(args)
        rep[kv[0]], rep[kv[1]] = (args[i].repeat_interleave(g, dim=2)
                                  .contiguous() for i in kv)
        want = plain(*args)
        res = {}
        for layout, a in (("packed", args), ("per_head", rep)):
            res[layout] = {"max_abs_err": _err(fn(*a), want), "ms": [],
                           "device_ms": []}
        for layout, a in (("packed", args), ("per_head", rep),
                          ("per_head", rep), ("packed", args)):
            res[layout]["ms"].append(cs.time_ms(lambda: fn(*a), reps=reps,
                                                inner=inner))
            res[layout]["device_ms"].append(cs.device_ms(lambda: fn(*a)))
        out[name] = res

    def sdpa(name, qkv, reps, inner):
        qt, kt, vt = (t.transpose(1, 2) for t in qkv)

        def fn():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
        out[name]["sdpa_ms"] = cs.time_ms(fn, reps=reps, inner=inner)
        out[name]["sdpa_device_ms"] = cs.device_ms(fn)

    (q, k, v), o_acc, lse_acc = cs.fwd_inputs(torch.bfloat16, dev)
    pos = torch.arange(1024, dtype=torch.int32, device=dev)
    bench("B1_s1024", lambda *a: fa.flash_attention_fwd(*a, window=4096),
          lambda *a: fa.flash_attention_fwd_plain(*a, window=4096),
          (q, k, v, pos, pos), (1, 2), 20, 5)
    sdpa("B1_s1024", (q, k, v), 20, 5)

    g = torch.Generator(device=dev).manual_seed(3)
    S = 4096
    q = torch.randn((1, S, 32, 80), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((1, S, 8, 80), generator=g, device=dev).bfloat16()
            for _ in range(2))
    o_acc = torch.randn((1, S, 32, 80), generator=g, device=dev)
    lse_acc = 3 * torch.randn((1, 32, S), generator=g, device=dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    bench("B2_s4096", lambda *a: fa.flash_attention_fwd(*a, window=4096),
          lambda *a: fa.flash_attention_fwd_plain(*a, window=4096),
          (q, k, v, pos, pos, o_acc, lse_acc), (1, 2), 10, 2)
    sdpa("B2_s4096", (q, k, v), 10, 2)
    del q, k, v, o_acc, lse_acc
    torch.cuda.empty_cache()

    (q5, k5, v5), pq5, pk5 = cs.ragged_inputs(dev, torch.bfloat16, 1, 1056,
                                              [1024] * 4, "decode")
    bench("B5_decode", lambda *a: rp.ragged_prefill_fwd(*a, window=4096),
          lambda *a: rp.ragged_prefill_fwd_plain(*a, window=4096),
          (q5, k5, v5, pq5, pk5), (1, 2), 20, 5)
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
