"""Serving driver on top of ``repro_torch.engine`` (engine and ``--legacy``
modes of ``repro.launch.serve``).

Engine mode serves a mixed workload of ``--requests`` requests with
staggered prompt lengths and budgets by continuous batching over the paged
KV cache, and prints per-request generations and the engine metrics. The
requests are greedy unless ``--temperature`` > 0, which samples each with
``--top-k`` / ``--top-p`` and seed ``--seed + i``. ``--metrics-dump FILE``
writes the engine's ``obs`` registry after the run (Prometheus text, JSON
when FILE ends ``.json``), ``--trace-out FILE`` a Chrome-trace JSON of its
request, step, prefill and decode spans.
``--prefill-chunk N`` prefills prompts in page-aligned chunks of about N
tokens; ``--prefix-cache`` shares a ``--system-prompt-len``-token prefix
over every request and turns the block-hash prefix cache on, so later
requests prefill only their uncached suffix.

``--legacy`` is the static-batch greedy path (it ignores the sampling
flags, as the JAX launcher's does): one batch of ``--batch``
random prompts of ``--prompt-len`` tokens, prefilled at the prompt length,
the cache expanded to capacity, then ``--gen - 1`` decode steps against the
contiguous cache (kernel B5 once per layer and step on the card).

Runs on the CUDA card by default (``--device cuda``), and raises if there is
none; ``--device cpu`` runs the plain PyTorch versions of the kernels:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \\
      --smoke --device cpu --requests 8 --prompt-len 16 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \\
      --smoke --device cpu --prefix-cache --prefill-chunk 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \\
      --smoke --device cpu --temperature 0.8 --top-k 40 --top-p 0.9 \\
      --metrics-dump "$TMPDIR/m.prom" --trace-out "$TMPDIR/trace.json"
  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \\
      --smoke --device cpu --legacy

``--devices N --data D --c C`` serves on N ranks: D data replicas of SP
degree N / D (C * C * R), one ``ThreadMesh`` thread per rank on the one
device, with the JAX launcher's meanings; ``--c`` unset lets the cost model
pick C (C = 1 at P = 1). ``--save-plan FILE`` writes the resolved serve
plan, ``--plan FILE`` serves a written one (its arch, ranks and
arrangement; ``--smoke`` picks the width), and ``--comm-report FILE``
writes the plan's attention island's measured-vs-analytical wire bytes
(``obs.commlog.comm_report``):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \\
      --smoke --device cpu --devices 8 --c 2 --comm-report "$TMPDIR/c.json"

The full-width model (drop ``--smoke``) draws seeded random weights on the
card. The JAX driver's other modes (``--replicas``, ``--roles``,
``--http``) are not ported yet and raise.
"""

import argparse


def legacy_start(model, plan, tokens, gen: int):
    """The static-batch path up to its first decode step, on one card (the
    JAX ``_legacy_main``'s steps at SP degree 1): prefill ``tokens``
    (B, prompt_len) at their own length and copy the cache into one of
    capacity ``prompt_len + gen``. Returns ``(first tokens (B, 1), cache,
    decode)``, ``decode`` the step of ``serve.step.build_decode_step``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.serve import kv_cache, step as serve_step

    B, prompt_len = tokens.shape
    capacity = prompt_len + gen
    run_cfg = plan.run_config()
    prefill = serve_step.build_prefill_step(
        model, run_cfg, ShapeConfig("serve", prompt_len, B, "prefill"))
    tok, cache_p = prefill(tokens)
    cache = kv_cache.init_cache(model.cfg, B, capacity, model.device)
    for name in ("k", "v"):
        cache[name][:, :, :prompt_len] = cache_p[name]
    decode = serve_step.build_decode_step(
        model, run_cfg, ShapeConfig("serve", capacity, B, "decode"))
    return tok, cache, decode


def legacy_generate(model, plan, tokens, gen: int):
    """Static-batch greedy generation: ``legacy_start``, then ``gen - 1``
    decode steps, each at the batch's true cache length. Returns the
    (B, gen) generated tokens, int64."""
    import torch

    B, prompt_len = tokens.shape
    tok, cache, decode = legacy_start(model, plan, tokens, gen)
    generated = [tok]
    for i in range(gen - 1):
        cache_len = torch.full((B,), prompt_len + i, dtype=torch.int32,
                               device=model.device)
        tok = decode(cache, tok.long(), cache_len)
        generated.append(tok)
    return torch.cat(generated, dim=1).long()


def _legacy_main(args, plan, cfg, device):
    import numpy as np
    import torch

    from repro_torch.engine.engine import resolve_device
    from repro_torch.models.factory import build_model

    device = resolve_device(device)
    model = build_model(cfg, device=device, seed=args.seed)
    rng = np.random.default_rng(args.seed + 1)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))).to(device)
    out = legacy_generate(model, plan, tokens, args.gen)
    print(f"[serve --legacy] prompt {tuple(tokens.shape)} -> generated "
          f"{tuple(out.shape)}:")
    print(out.cpu().numpy())
    return out


def _engine_main(args, plan, device, registry=None, tracer=None):
    import numpy as np

    from repro_torch.engine import EngineConfig, Request, build_engine

    engine = build_engine(
        plan.arch, smoke=args.smoke, plan=plan, init_seed=args.seed,
        device=device, eng=EngineConfig(pages_per_shard=args.pages_per_shard,
                                        prefill_chunk=args.prefill_chunk),
        registry=registry, tracer=tracer)
    rng = np.random.default_rng(args.seed)
    vocab = engine.cfg.vocab_size
    shared = (rng.integers(0, vocab, args.system_prompt_len).tolist()
              if args.prefix_cache else [])
    reqs = []
    for i in range(args.requests):
        # staggered mixed workload: prompts and budgets vary per request
        plen = max(1, args.prompt_len // 2 + (i * 3) % (args.prompt_len + 1))
        gen = max(1, args.gen // 2 + i % (args.gen + 1))
        reqs.append(Request(
            uid=f"req{i}",
            tokens=shared + rng.integers(0, vocab, plen).tolist(),
            max_new_tokens=gen, temperature=args.temperature,
            top_k=args.top_k, top_p=args.top_p, seed=args.seed + i))
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
    ap.add_argument("--arch", default=None,
                    help="architecture id (optional with --plan)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks (ThreadMesh threads on the one device)")
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel replicas (divides --devices)")
    ap.add_argument("--c", type=int, default=None,
                    help="StarTrail C (default: cost-model pick)")
    ap.add_argument("--plan", default=None,
                    help="load a persisted serve ExecutionPlan json")
    ap.add_argument("--save-plan", default=None,
                    help="persist the resolved serve plan to this path")
    ap.add_argument("--comm-report", default=None,
                    help="measure the plan's attention island's wire bytes "
                         "against the analytical ones and write the report "
                         "(JSON) here")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--kernel", default=None, choices=["ref", "cuda"],
                    help="attention kernels (default cuda; on CPU tensors "
                         "it runs the plain versions)")
    ap.add_argument("--legacy", action="store_true",
                    help="static-batch greedy decode instead of the engine")
    ap.add_argument("--batch", type=int, default=2, help="legacy batch size")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--pages-per-shard", type=int, default=128)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prefill prompts in chunks of about this many "
                         "tokens (0: whole prompts)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share a system prompt over the requests and "
                         "reuse its cached pages")
    ap.add_argument("--system-prompt-len", type=int, default=32,
                    help="tokens of the shared prefix under --prefix-cache")
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-dump", default=None,
                    help="write the obs registry here after the run "
                         "(Prometheus text; .json suffix -> JSON dump)")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome-trace-format JSON timeline of the "
                         "engine's request and step spans here")
    # the JAX driver's other modes, rejected until they are ported
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--roles", default=None)
    ap.add_argument("--http", action="store_true")
    args = ap.parse_args(argv)
    if not args.plan and not args.arch:
        ap.error("--arch is required (unless --plan carries it)")
    for flag, on in (("--replicas", args.replicas > 1),
                     ("--roles", bool(args.roles)), ("--http", args.http)):
        if on:
            raise NotImplementedError(
                f"repro_torch.launch.serve {flag} is not ported yet "
                "(ROADMAP.md §A); engine and --legacy modes only")

    from repro_torch.configs import registry
    from repro_torch.plan import ExecutionPlan, make_serve_plan

    get_cfg = registry.get_smoke if args.smoke else registry.get
    if args.plan:
        plan = ExecutionPlan.load(args.plan)
        cfg = get_cfg(plan.arch)
        print(f"[serve] loaded plan {args.plan}")
    else:
        cfg = get_cfg(args.arch)
        plan = make_serve_plan(
            cfg, arch=args.arch, n_devices=args.devices, data=args.data,
            c=args.c, decode_batch=args.max_slots, page_size=args.page_size,
            max_len=args.max_len, kernel_impl=args.kernel,
            block_impl=args.kernel, prefix_cache=args.prefix_cache)
    print(f"[serve] plan: P_sp={plan.sp_size} scheme={plan.scheme} "
          f"C={plan.c} R={plan.r} data={plan.data} "
          f"kernel={plan.kernel_impl} block={plan.block_impl} "
          f"slots={plan.decode_batch} page={plan.page_size} "
          f"capacity={plan.seq_len} prefix_cache={plan.prefix_cache} "
          f"device={args.device}")
    if args.save_plan:
        print(f"[serve] plan saved -> {plan.save(args.save_plan)}")
    from repro_torch import obs

    registry = obs.Registry()
    tracer = obs.Tracer(enabled=bool(args.trace_out))
    if args.legacy:
        if plan.n_devices != 1:
            raise NotImplementedError(
                "repro_torch.launch.serve --legacy at --devices > 1 is not "
                "ported yet (ROADMAP.md §A10); the engine serves any P")
        out = _legacy_main(args, plan, cfg, args.device)
    else:
        out = _engine_main(args, plan, args.device, registry=registry,
                           tracer=tracer)
    if args.metrics_dump:
        fmt = "json" if args.metrics_dump.endswith(".json") else "prometheus"
        registry.dump(args.metrics_dump, fmt=fmt)
        print(f"[serve] metrics dump -> {args.metrics_dump} ({fmt})")
    if args.trace_out:
        tracer.dump(args.trace_out)
        print(f"[serve] trace ({len(tracer.events())} events) -> "
              f"{args.trace_out}")
    if args.comm_report:
        import json
        import pathlib

        from repro_torch.engine.engine import resolve_device
        from repro_torch.obs import commlog

        rep = commlog.comm_report(cfg, plan,
                                  device=resolve_device(args.device))
        path = pathlib.Path(args.comm_report)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(rep, indent=2))
        ratios = {k: v["ratio"] for k, v in rep["per_collective"].items()}
        print(f"[serve] comm report -> {path} "
              f"within_tolerance={rep['within_tolerance']} ratios={ratios}")
    return out


if __name__ == "__main__":
    main()
