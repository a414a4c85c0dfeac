#!/usr/bin/env python3
"""Time and check the bf16 paged kernels (B4, B6) of one or more checkouts
of this repository on one CUDA card, each in its own process, in the order
given (repeat a path to run it in turns: parent, change, change, parent).

    python3 scripts/compare_paged.py ROOT [ROOT ...]

For each ROOT (a directory holding ``chip_smoke.py`` and
``src/repro_torch``) one JSON line: the ptxas registers and spills of its
paged kernels (the first time a ROOT appears) and, at ``chip_smoke.py``'s
timing shapes, each kernel's largest error against its plain version and
its milliseconds per call from CUDA events around bursts
(``chip_smoke.time_ms``) and from the device alone
(``chip_smoke.device_ms``): B4 at ``decode_1k`` (q (4,1,32,80) against the
pool (512,16,8,80), ~1K keys a row, a table of 64 entries) and again with
the engine's table of 128 entries (max_len 2048, pages of 16), and B6 for
a 256-query chunk after a 1024-token prefix; then both again at each shape
of ``WIDE`` (minitron-8b's heads of 128, GPT-3B's of 256 at pages of 16
and 128) where the checkout's B4 and B6 take it. Where the checkout splits
B4's keys over CTAs (``paged_decode.decode_splits``), B4 is also timed at
each fixed split count of ``SPLITS`` beside the wrapper's own choice. The
card's name and power limit come first.
"""

import json
import os
import subprocess
import sys

SPLITS = (1, 2, 3, 4, 5, 8)
# name: (head size, (query, kv) heads, page size); B4 at 4 slots of
# cache lengths 1023/1010/1000/990, B6 at a 256-query chunk after 1024
WIDE = {"d128_minitron": (128, (32, 8), 16),
        "d256_gpt3b": (256, (12, 12), 16),
        "d256_gpt3b_page128": (256, (12, 12), 128)}


def one(root, ptxas):
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_prefill as pp

    dev = torch.device("cuda")
    out = {"root": root}
    if ptxas:
        out["ptxas"] = [line for line in _build.build_info()["ptxas"]
                        if "paged" in line and "ILi80E" in line]

    def bench(fn, plain):
        want = plain()
        got = fn()
        return {"max_abs_err": max(float((a - b).abs().max())
                                   for a, b in zip(got, want)),
                "ms": cs.time_ms(fn), "device_ms": cs.device_ms(fn)}

    sp, rank, window, cls = cs.paged_cases()["decode_1k"]
    q, pk, pv, table, cl = cs.paged_inputs(dev, sp, cls)
    wide = torch.cat([table, torch.full_like(table, -1)], dim=1)
    kw = dict(sp=sp, page_size=16, window=window)
    for name, tbl in (("B4_decode_1k", table), ("B4_decode_1k_w128", wide)):
        args = (q, pk, pv, tbl, cl, rank)
        out[name] = bench(lambda: pd.paged_decode_attention(*args, **kw),
                          lambda: pd.paged_decode_attention_plain(*args,
                                                                  **kw))
        if hasattr(pd, "decode_splits"):
            auto = pd.decode_splits
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            out[name]["splits"] = auto(4, 8, 80, tbl.shape[1], 16, sms)
            by = {}
            for n in SPLITS:
                pd.decode_splits = lambda *a, n=n: n
                by[n] = cs.device_ms(
                    lambda: pd.paged_decode_attention(*args, **kw))
            pd.decode_splits = auto
            out[name]["device_ms_by_splits"] = by
    args6 = cs.paged_prefill_inputs(dev, torch.bfloat16, [1024], [])
    kw6 = dict(sp=1, page_size=16, window=4096)
    out["B6_prefix_1024"] = bench(
        lambda: pp.paged_prefill_attention(*args6, 0, **kw6),
        lambda: pp.paged_prefill_attention_plain(*args6, 0, **kw6))
    for name, (d, heads, ps) in WIDE.items():
        kw = dict(sp=1, page_size=ps)
        try:
            args4 = (*cs.paged_inputs(dev, 1, [1023, 1010, 1000, 990],
                                      d=d, ps=ps, heads=heads), 0)
            out[f"B4_{name}"] = bench(
                lambda: pd.paged_decode_attention(*args4, **kw),
                lambda: pd.paged_decode_attention_plain(*args4, **kw))
            args6 = (*cs.paged_prefill_inputs(dev, torch.bfloat16, [1024],
                                              [], d=d, ps=ps, heads=heads),
                     0)
            out[f"B6_{name}"] = bench(
                lambda: pp.paged_prefill_attention(*args6, **kw),
                lambda: pp.paged_prefill_attention_plain(*args6, **kw))
        except (TypeError, ValueError, RuntimeError) as e:
            out[name] = f"not taken: {e}"   # an older checkout refuses it
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
