"""Serving driver on top of ``repro_torch.engine`` (engine mode of
``repro.launch.serve``): a mixed workload of ``--requests`` greedy requests
with staggered prompt lengths and budgets, served by continuous batching
over the paged KV cache; prints per-request generations and the engine
metrics.

Runs on the CUDA card by default (``--device cuda``), and raises if there is
none; ``--device cpu`` runs the plain PyTorch versions of the kernels:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \\
      --smoke --device cpu --requests 8 --prompt-len 16 --gen 8

The full-width model (drop ``--smoke``) draws seeded random weights on the
card. The JAX driver's other modes (``--legacy``, ``--replicas``,
``--prefix-cache``, ``--roles``, ``--http``) are not ported yet and raise.
"""

import argparse


def _engine_main(args, plan, cfg, device):
    import numpy as np

    from repro_torch.engine import Engine, EngineConfig, Request
    from repro_torch.engine.engine import resolve_device
    from repro_torch.models.factory import build_model

    device = resolve_device(device)
    model = build_model(cfg, device=device, seed=args.seed)
    engine = Engine(model, plan,
                    EngineConfig(pages_per_shard=args.pages_per_shard,
                                 prefill_chunk=args.prefill_chunk))
    rng = np.random.default_rng(args.seed)
    vocab = engine.cfg.vocab_size
    reqs = []
    for i in range(args.requests):
        # staggered mixed workload: prompts and budgets vary per request
        plen = max(1, args.prompt_len // 2 + (i * 3) % (args.prompt_len + 1))
        gen = max(1, args.gen // 2 + i % (args.gen + 1))
        reqs.append(Request(
            uid=f"req{i}", tokens=rng.integers(0, vocab, plen).tolist(),
            max_new_tokens=gen, temperature=args.temperature,
            seed=args.seed + i))
    for r in reqs:
        rej = engine.add_request(r)
        if rej is not None:
            raise SystemExit(f"[serve] {r.uid} rejected: {rej.detail}")
    out = engine.run()
    for r in reqs:
        print(f"[serve] {r.uid}: prompt_len={r.prompt_len} "
              f"-> {out[r.uid]}")
    stats = engine.metrics.to_dict()
    print("[serve] metrics: " + ", ".join(
        f"{k}={v:.3g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in sorted(stats.items())))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--kernel", default=None, choices=["ref", "cuda"],
                    help="paged-decode and ring-block kernels (default "
                         "cuda; on CPU tensors it runs the plain versions)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--pages-per-shard", type=int, default=128)
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    # the JAX driver's other modes, rejected until they are ported
    ap.add_argument("--legacy", action="store_true")
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--roles", default=None)
    ap.add_argument("--http", action="store_true")
    args = ap.parse_args(argv)
    for flag, on in (("--legacy", args.legacy),
                     ("--replicas", args.replicas > 1),
                     ("--prefix-cache", args.prefix_cache),
                     ("--roles", bool(args.roles)), ("--http", args.http)):
        if on:
            raise NotImplementedError(
                f"repro_torch.launch.serve {flag} is not ported yet "
                "(ROADMAP.md §A); engine mode only")

    from repro_torch.configs import registry
    from repro_torch.plan import make_serve_plan

    cfg = registry.get_smoke(args.arch) if args.smoke \
        else registry.get(args.arch)
    plan = make_serve_plan(
        cfg, arch=args.arch, c=1,
        decode_batch=args.max_slots, page_size=args.page_size,
        max_len=args.max_len, kernel_impl=args.kernel,
        block_impl=args.kernel)
    print(f"[serve] plan: P_sp={plan.sp_size} C={plan.c} R={plan.r} "
          f"kernel={plan.kernel_impl} block={plan.block_impl} "
          f"slots={plan.decode_batch} page={plan.page_size} "
          f"capacity={plan.seq_len} device={args.device}")
    return _engine_main(args, plan, cfg, args.device)


if __name__ == "__main__":
    main()
