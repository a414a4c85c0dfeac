#!/usr/bin/env python3
"""Time the P = 8 ring of one or more checkouts of this repository on one
CUDA card, each in its own process, in the order given (repeat a path to
run it in turns: parent, change, change, parent).

    python3 scripts/compare_ring.py ROOT [ROOT ...]

For each ROOT (a directory holding ``src/repro_torch``) one JSON line, the
medians of the host's wall seconds (the device synchronised before and
after each run):
  * ``ring_fwd_bwd_s``: every rank's explicit StarTrail forward and backward
    at h2o-danube-1.8b's attention width (32q/8kv heads of 80, seq 4096,
    bf16, zigzag, causal) on ``ThreadMesh(2, 2)``, 10 runs after 2 warm-up
    ones, for each issue order the checkout has (``pipeline`` True and
    False; "None" where ``StarTrailConfig`` has no such field);
  * ``prefill_s``: full-width h2o-danube-1.8b (seeded bf16 weights) through
    the engine at P = 8 (C = 2, pages of 16): one step admitting one
    2000-token prompt, 3 runs after a first one.
The card's name and power limit come first.
"""

import json
import os
import subprocess
import sys

CHILD = r'''
import json, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.core import startrail as st
from repro_torch.dist.comm import ThreadMesh

dev = torch.device("cuda")
n, c, r = 4096, 2, 2
g = torch.Generator(device=dev).manual_seed(0)
q, k, v, do = (torch.randn((1, n, h, 80), generator=g,
                           device=dev).bfloat16() for h in (32, 8, 8, 32))
orders = ([True, False] if "pipeline" in st.StarTrailConfig.__dataclass_fields__
          else [None])


def rank_fn(comm):
    gi, ji, ti = (comm.axis_index(a) for a in cfg.axes)
    pos = st.shard_positions((gi * r + ji) * c + ti, n, 8, "zigzag").to(dev)
    o, res = st.startrail_forward(
        *(t[:, pos].contiguous() for t in (q, k, v)), cfg, comm)
    return st.startrail_backward(res, o, do[:, pos].contiguous(), cfg, comm)


mesh = ThreadMesh(c, r)
ring = {}
for pipe in orders:
    cfg = st.StarTrailConfig(seq_len=n, block_impl="cuda",
                             **({} if pipe is None else {"pipeline": pipe}))
    walls = []
    for _ in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh.run(rank_fn)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    ring[str(pipe)] = statistics.median(walls[2:])

from repro_torch.configs import registry
from repro_torch.engine import Engine, EngineConfig, Request
from repro_torch.models.factory import build_model
from repro_torch.plan import make_serve_plan

cfg_m = registry.get("h2o-danube-1.8b")
model = build_model(cfg_m, device=dev, seed=0)
pre = []
for i in range(4):
    plan = make_serve_plan(cfg_m, n_devices=8, c=2, decode_batch=4,
                           page_size=16, max_len=2048)
    eng = Engine(model, plan,
                 EngineConfig(pages_per_shard=512 // plan.sp_size))
    eng.add_request(Request(f"r{i}", list(range(1, 2001)), 1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    pre.append(time.perf_counter() - t0)
    del eng
print(json.dumps({"root": sys.argv[2], "ring_fwd_bwd_s": ring,
                  "prefill_s": statistics.median(pre[1:]),
                  "prefills": pre}))
'''


def main(roots):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    for root in roots:
        res = subprocess.run(
            [sys.executable, "-c", CHILD, os.path.join(root, "src"), root],
            capture_output=True, text=True, timeout=900)
        if res.returncode:
            print(res.stderr[-3000:], file=sys.stderr)
            return res.returncode
        print(res.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
