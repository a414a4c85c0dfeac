"""Serving driver on top of ``repro_torch.engine`` and
``repro_torch.gateway`` (the port of ``repro.launch.serve``).

Engine mode serves a mixed workload of ``--requests`` requests with
staggered prompt lengths and budgets by continuous batching over the paged
KV cache, and prints per-request generations and the engine metrics. The
requests are greedy unless ``--temperature`` > 0, which samples each with
``--top-k`` / ``--top-p`` and seed ``--seed + i``. ``--metrics-dump FILE``
writes the ``obs`` registry after the run (Prometheus text, JSON when FILE
ends ``.json``), ``--trace-out FILE`` a Chrome-trace JSON of the request,
step, prefill and decode spans. ``--prefill-chunk N`` prefills prompts in
page-aligned chunks of about N tokens.

**Gateway mode** (``--replicas N > 1``, ``--roles`` or ``--prefix-cache``,
as in the JAX launcher) serves the workload through ``gateway.Gateway``:
N engine replicas on the one card sharing one model, prefix-aware and
load-aware routing with session affinity, and two request families each
behind its own ``--system-prompt-len``-token system prompt (one session
each), so the prefix caches have something to hit. It prints each
request's replica and stream, the gateway's routing, hit-rate and
eviction metrics, each replica's line, the host tier's counters when it
is on (``--host-tier-bytes N``: pinned-host KV tier of N bytes a replica
behind the prefix cache) and ``plan.cost.prefix_cache_value``'s analytical
line. ``--roles prefill,decode`` disaggregates: one engine a role, with
each finished prompt's KV handed from the prefill replica to a decode
replica through the KV connector.

**HTTP front-end mode** (``--http``) starts the process-separated
``repro_torch.frontend`` stack instead of a canned workload: ``--workers``
engine processes (spawned; each draws the weights from ``--seed`` on the
device; ``0`` keeps one in-process replica), an asyncio HTTP/SSE server on
``--host:--port`` streaming tokens per request, priority classes
(``--priority-classes``, highest first) with optional preemption
(``--preempt``), a class budget (``--class-budget-tokens``) and SLO-priced
admission (``--slo-ttft-ms``, scaled by ``--slo-calibration``). SIGTERM
drains: streams in flight finish, host-tier spills flush, workers join.
``python -m repro_torch.frontend.client --port P --verify`` drives it.

``--legacy`` is the static-batch greedy path (it ignores the sampling
flags, as the JAX launcher's does): one batch of ``--batch``
random prompts of ``--prompt-len`` tokens, prefilled at the prompt length,
the cache expanded to capacity (padded to a multiple of the SP degree),
then ``--gen - 1`` decode steps against the contiguous cache (kernel B5
once per rank, layer and step on the card). It runs on the plan's ranks
(``--devices N``, as ``--backend`` runs them) and is the only path
that serves the xLSTM, hybrid, encoder-decoder and VLM families, which the
engine refuses, as the JAX engine does. For the encoder-decoder
(``--arch seamless-m4t-large-v2``) the batch also gets ``--prompt-len``
frames of seeded random embeddings (``--seed``), which the encoder
prefills; the decoder's prompt tokens then go through decode steps one at
a time, each at its own position, before the ``--gen`` new tokens:

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch seamless-m4t-large-v2 --smoke --device cpu --legacy

For the VLM (``--arch paligemma-3b``) the batch gets ``--prompt-len`` seeded
random patch embeddings, whose first ``int(0.125 * prompt_len)`` replace
the prompt's embeddings as its bidirectional image prefix (the JAX
launcher feeds zeros, which keep the prefix rows zero in every layer):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma-3b \\
      --smoke --device cpu --legacy --devices 4 --c 2 --prompt-len 16

For the xLSTM family:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \\
      --smoke --device cpu --legacy --devices 4 --c 2 --prompt-len 16

Runs on the CUDA card by default (``--device cuda``), and raises if there is
none; ``--device cpu`` runs the plain PyTorch versions of the kernels:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \\
      --smoke --device cpu --requests 8 --prompt-len 16 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \\
      --smoke --device cpu --replicas 2 --prefix-cache --prefill-chunk 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \\
      --smoke --device cpu --roles prefill,decode --prefix-cache \\
      --host-tier-bytes 1048576
  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \\
      --smoke --device cpu --temperature 0.8 --top-k 40 --top-p 0.9 \\
      --metrics-dump "$TMPDIR/m.prom" --trace-out "$TMPDIR/trace.json"
  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \\
      --smoke --device cpu --http --workers 2 --port 8080
  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \\
      --smoke --device cpu --legacy

``--devices N --data D --c C`` serves on N ranks: D data replicas of SP
degree N / D (C * C * R), with the JAX launcher's meanings, one
``ThreadMesh`` thread per rank on the one device by default (``--backend
threads``); with several gateway replicas or workers N is split evenly
between them (default: one rank each).
``--c`` unset lets the cost model pick C (C = 1 at P = 1). ``--save-plan
FILE`` writes the resolved serve plan (``{"plans": [...]}`` for roles),
``--plan FILE`` serves a written one, the port's or the JAX launcher's
(its arch, ranks, arrangement, replicas and roles; ``--smoke`` picks the
width), and ``--comm-report FILE`` writes the plan's attention island's
measured-vs-analytical wire bytes (``obs.commlog.comm_report``):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \\
      --smoke --device cpu --devices 8 --c 2 --comm-report "$TMPDIR/c.json"

The full-width model (drop ``--smoke``) draws seeded random weights on the
card.

``--backend gloo|nccl`` runs the N ranks as processes instead
(``dist.procs.ProcessMesh``: spawned, one ``dist.comm.ProcessComm`` each,
the plan's arrangement; or joined under ``torchrun``), in engine mode and
under ``--legacy``. Every rank process draws the whole model from
``--seed`` on its device, keeps only its shards
(``factory.build_rank_model``) and serves its own rank with its own pool
shard: an ``Engine`` in each process, fed the same requests step by step
(``engine.engine``'s module doc), or the static batch's steps on its rank.
The streams are ``--backend threads``' on the same device, and rank 0's
are printed as ``--backend threads`` prints them; rank 0 writes
``--metrics-dump`` and ``--trace-out``, and ``--comm-report`` gathers
every rank's ledger of the island to it. ``dist.elastic.plan_mesh`` fits
the (data, SP) split to the ranks there are (a rank it strands serves
nothing). gloo runs on the CPU, or several ranks on one card; nccl takes
one card per rank:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \\
      --smoke --device cpu --backend gloo --devices 4 --c 2
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
      --arch h2o-danube-1.8b --smoke --backend nccl --c 2 --legacy

The gateway (``--replicas > 1``, ``--roles``, ``--prefix-cache``) and the
HTTP front end (``--http``, ``--workers``) serve on threads only: with
``--backend gloo|nccl`` they raise ``NotImplementedError`` (ROADMAP.md §A
item 1 a, its remaining half).
"""

import argparse


def legacy_start(model, plan, tokens, gen: int, frames=None, patches=None,
                 comm=None):
    """The static-batch path up to its first decode step, on the plan's
    ranks (one card, or its ``ThreadMesh``; the JAX ``_legacy_main``'s
    steps), or on this rank process's rank when ``comm`` is its
    ``ProcessComm`` (``model`` its ``rank_model``; every rank passes the
    same inputs): prefill ``tokens`` (B, prompt_len) at their own length
    and copy each rank's cache into one of capacity ``prompt_len + gen``
    padded to a multiple of the SP degree: the prompt's K/V at its
    positions, recurrent states as they are. Returns ``(first tokens (B,
    1), caches, decode)``, ``decode`` the step of
    ``serve.step.build_decode_step`` and ``caches`` every rank's cache, in
    rank order (this rank's alone in a rank process). An encoder-decoder
    needs ``frames`` (B, S_enc, D): the encoder prefills them, and the
    decoder's prompt goes through decode steps (``_encdec_start``). A VLM
    takes ``patches`` (B, prompt_len, D): the prompt's first
    ``int(prefix_len_frac * prompt_len)`` positions are its image prefix
    (``serve.step.lm_prefill``)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.serve import kv_cache, step as serve_step

    B, prompt_len = tokens.shape
    sp = plan.sp_size
    capacity = -(-(prompt_len + gen) // sp) * sp    # pad to an SP multiple
    if model.cfg.encdec:
        return _encdec_start(model, plan, tokens, frames, capacity, comm)
    run_cfg = plan.run_config()
    mesh = comm if comm is not None else plan.build_mesh()
    prefill = serve_step.build_prefill_step(
        model, run_cfg, ShapeConfig("serve", prompt_len, B, "prefill"), mesh)
    tok, caches_p = prefill(tokens, patches)
    decode = serve_step.build_decode_step(
        model, run_cfg, ShapeConfig("serve", capacity, B, "decode"), mesh)
    caches = [kv_cache.init_cache(model.cfg, decode.steps.rows,
                                  capacity // sp,
                                  model.device) for _ in caches_p]
    decode.steps.fill(caches, caches_p, prompt_len)
    return tok, caches, decode


def encdec_caches(model, plan, frames, capacity: int, comm=None):
    """An encoder-decoder's serving state on the plan's ranks (this rank
    process's alone with ``comm``, as ``legacy_start``): ``frames`` (B,
    S_enc, D) through the encoder (``serve.step.build_prefill_step``),
    and every rank's cache, in rank order, of ``capacity`` decoder
    positions (a multiple of the SP degree) holding its slice of the
    encoder output at the encoder's length. Returns ``(caches, decode)``,
    ``decode`` the step of ``serve.step.build_decode_step``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.serve import kv_cache, step as serve_step

    if frames is None:
        raise ValueError(f"{model.cfg.name}: the encoder-decoder needs "
                         "frames (B, S_enc, D) for its encoder")
    B = frames.shape[0]
    run_cfg = plan.run_config()
    mesh = comm if comm is not None else plan.build_mesh()
    enc_outs = serve_step.build_prefill_step(
        model, run_cfg, ShapeConfig("serve", frames.shape[1], B, "prefill"),
        mesh)(frames)
    decode = serve_step.build_decode_step(
        model, run_cfg, ShapeConfig("serve", capacity, B, "decode"), mesh)
    caches = []
    for enc_out in enc_outs:
        cache = kv_cache.init_cache(model.cfg, decode.steps.rows,
                                    capacity // plan.sp_size, model.device,
                                    enc_len=enc_out.shape[1])
        cache["enc_out"].copy_(enc_out)
        caches.append(cache)
    return caches, decode


def _encdec_start(model, plan, tokens, frames, capacity: int, comm=None):
    """``legacy_start`` of an encoder-decoder (the JAX package has no
    decoder prefill): ``encdec_caches``, then the decoder's prompt
    ``tokens`` one at a time through decode steps, token ``t`` at cache
    length ``t``; the last step's tokens are the first generated."""
    import torch

    caches, decode = encdec_caches(model, plan, frames, capacity, comm)
    B, prompt_len = tokens.shape
    tok = None
    for t in range(prompt_len):
        cache_len = torch.full((B,), t, dtype=torch.int32,
                               device=model.device)
        tok = decode(caches, tokens[:, t:t + 1].long(), cache_len)
    return tok, caches, decode


def legacy_generate(model, plan, tokens, gen: int, frames=None,
                    patches=None, comm=None):
    """Static-batch greedy generation: ``legacy_start``, then ``gen - 1``
    decode steps, each at the batch's true cache length. Returns the
    (B, gen) generated tokens, int64 (every row, on every rank process
    with ``comm``). ``frames`` (B, S_enc, D): the encoder's input of an
    encoder-decoder; ``patches`` (B, prompt_len, D): a VLM's image
    prefix."""
    import torch

    B, prompt_len = tokens.shape
    tok, caches, decode = legacy_start(model, plan, tokens, gen, frames,
                                       patches, comm)
    generated = [tok]
    for i in range(gen - 1):
        cache_len = torch.full((B,), prompt_len + i, dtype=torch.int32,
                               device=model.device)
        tok = decode(caches, tok.long(), cache_len)
        generated.append(tok)
    return torch.cat(generated, dim=1).long()


def _legacy_inputs(args, cfg, device):
    """The static batch: seeded prompts, and an encoder-decoder's frames
    or a VLM's patches, on ``device``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(args.seed + 1)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))).to(device)
    frames = patches = None
    if cfg.frontend_stub is not None:
        # seeded random frame or patch embeddings, where the JAX launcher
        # feeds zeros: zero frames would make every encoder output, so
        # every cross-attention's K and V, zero; zero patches would keep
        # every layer's prefix rows exactly zero (ROADMAP.md §C)
        emb = torch.from_numpy(np.random.default_rng(
            args.seed).standard_normal(
                (args.batch, args.prompt_len, cfg.d_model),
                dtype=np.float32)).to(device)
        if cfg.encdec:
            frames = emb
        else:
            patches = emb.to(getattr(torch, cfg.param_dtype))
    return tokens, frames, patches


def _legacy_main(args, plan, cfg, device, comm=None):
    """The static batch's streams (B, gen), on the plan's ranks, or on
    this rank process's own rank with ``comm`` (its ``rank_model``)."""
    from repro_torch.engine.engine import resolve_device
    from repro_torch.models.factory import build_model, build_rank_model

    device = resolve_device(device)
    model = (build_model(cfg, device=device, seed=args.seed) if comm is None
             else build_rank_model(cfg, comm, plan.sharding_rules, device,
                                   args.seed))
    tokens, frames, patches = _legacy_inputs(args, cfg, device)
    return legacy_generate(model, plan, tokens, args.gen, frames, patches,
                           comm)


def _print_legacy(args, out) -> None:
    print(f"[serve --legacy] prompt {(args.batch, args.prompt_len)} -> "
          f"generated {tuple(out.shape)}:")
    print(out.cpu().numpy())


def _requests(args, vocab: int, shared=None):
    """The canned workload: ``--requests`` requests, prompts and budgets
    staggered; request ``i`` follows system prompt ``shared[i % 2]`` when
    ``shared`` is given (the gateway's two families)."""
    import numpy as np

    from repro_torch.engine import Request

    rng = np.random.default_rng(args.seed)
    if shared is not None:
        shared = [rng.integers(0, vocab, args.system_prompt_len).tolist()
                  if args.system_prompt_len else [] for _ in range(2)]
    reqs = []
    for i in range(args.requests):
        plen = max(1, args.prompt_len // 2 + (i * 3) % (args.prompt_len + 1))
        gen = max(1, args.gen // 2 + i % (args.gen + 1))
        prefix = shared[i % 2] if shared is not None else []
        reqs.append(Request(
            uid=f"req{i}",
            tokens=prefix + rng.integers(0, vocab, plen).tolist(),
            max_new_tokens=gen, temperature=args.temperature,
            top_k=args.top_k, top_p=args.top_p, seed=args.seed + i))
    return reqs


def _fmt(stats) -> str:
    return ", ".join(f"{k}={v:.3g}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in sorted(stats.items()))


def _engine_config(args):
    from repro_torch.engine import EngineConfig

    return EngineConfig(pages_per_shard=args.pages_per_shard,
                        prefill_chunk=args.prefill_chunk)


def _engine_main(args, plan, device, registry=None, tracer=None, comm=None):
    """The canned workload through one engine (this rank process's, with
    ``comm``): the streams and the engine's metrics."""
    from repro_torch.engine import build_engine

    engine = build_engine(
        plan.arch, smoke=args.smoke, plan=plan, init_seed=args.seed,
        device=device, eng=_engine_config(args), registry=registry,
        tracer=tracer, comm=comm)
    for r in _requests(args, engine.cfg.vocab_size):
        rej = engine.add_request(r)
        if rej is not None:
            raise SystemExit(f"[serve] {r.uid} rejected: {rej.detail}")
    return engine.run(), engine.metrics.to_dict()


def _print_engine(args, cfg, out, metrics) -> None:
    for r in _requests(args, cfg.vocab_size):
        print(f"[serve] {r.uid}: prompt_len={r.prompt_len} "
              f"-> {out[r.uid]}")
    print(f"[serve] metrics: {_fmt(metrics)}")


def _gateway_main(args, plan, cfg, device, registry=None, tracer=None,
                  plans=None):
    """The canned workload through ``gateway.Gateway``: two families
    behind their own system prompts, each one session, one request added
    per gateway step (the JAX launcher's gateway mode)."""
    from repro_torch.engine.engine import resolve_device
    from repro_torch.gateway import Gateway
    from repro_torch.models.factory import build_model
    from repro_torch.plan import cost as plan_cost

    model = build_model(cfg, device=resolve_device(device), seed=args.seed)
    gw = Gateway(model, plan, _engine_config(args), registry=registry,
                 tracer=tracer, plans=plans)
    sys_len = args.system_prompt_len
    reqs = _requests(args, cfg.vocab_size, shared=True)
    for i, r in enumerate(reqs):
        rej = gw.add_request(r, session=f"sess{i % 2}" if sys_len else None)
        if not isinstance(rej, int):
            raise SystemExit(f"[gateway] {r.uid} rejected: {rej.detail}")
        gw.step()           # stream as the requests arrive
    out = gw.run()
    for r in reqs:
        print(f"[gateway] {r.uid} (replica {gw._owner[r.uid]}): "
              f"prompt_len={r.prompt_len} -> {out[r.uid]}")
    stats = gw.stats()
    tier = stats.pop("host_tier")
    per = stats.pop("per_replica")
    print(f"[gateway] metrics: {_fmt(stats)}")
    for i, m in enumerate(per):
        print(f"[gateway]   replica {i} ({gw.roles[i]}): "
              f"tokens={m['tokens_out']} "
              f"hit_rate={m['prefix_hit_rate']:.3g} "
              f"occupancy={m['occupancy']:.3g}")
    if tier["enabled"]:
        for i, t in enumerate(tier.pop("per_replica")):
            print(f"[gateway]   replica {i} host tier: {_fmt(t)}")
        print(f"[gateway] host tier: {_fmt(tier)}")
    if plan.prefix_cache and sys_len:
        roi = plan_cost.prefix_cache_value(
            cfg, prompt_len=sys_len + args.prompt_len, shared_len=sys_len,
            requests=max(args.requests // gw.replicas, 2),
            sp=plan.sp_size, page_size=plan.page_size,
            pages_per_shard=args.pages_per_shard, max_len=args.gen)
        print(f"[gateway] analytical cache value/replica: "
              f"hit_rate~{roi['hit_rate']:.2f} "
              f"saved_tokens~{roi['saved_tokens']} "
              f"cache_pages={roi['cache_pages']} fits={roi['fits']}")
    return out


def _frontend_main(args, plan, cfg, registry=None, tracer=None):
    """The process-separated front end: ``--workers`` engine processes
    (or one in-process replica) behind the orchestrator and the HTTP/SSE
    server, until SIGTERM, then drain."""
    import dataclasses

    from repro_torch.frontend.orchestrator import Orchestrator
    from repro_torch.frontend.protocol import make_worker_spec
    from repro_torch.frontend.server import run_server
    from repro_torch.frontend.slo import SLOAdmission, parse_classes
    from repro_torch.frontend.worker import LocalReplica, ProcReplica

    # each worker is a one-engine replica of the per-worker plan
    spec = make_worker_spec(
        plan=dataclasses.replace(plan, replicas=1), eng=_engine_config(args),
        init_seed=args.seed, trace=bool(args.trace_out), smoke=args.smoke,
        device=args.device)
    workers = max(args.workers, 0)
    if workers:
        from concurrent.futures import ThreadPoolExecutor

        print(f"[serve] spawning {workers} worker processes "
              f"({plan.n_devices} ranks each)...", flush=True)
        # the workers start together: each one's start is mostly its own
        # interpreter, torch import, CUDA context and model
        with ThreadPoolExecutor(workers) as ex:
            replicas = list(ex.map(lambda i: ProcReplica(i, spec),
                                   range(workers)))
        for r in replicas:
            print(f"[serve] worker {r.index} (pid {r.pid}) ready in "
                  f"{r.start_s:.1f} s", flush=True)
    else:
        print("[serve] --workers 0: one in-process replica", flush=True)
        replicas = [LocalReplica(0, spec)]
    classes = parse_classes(args.priority_classes,
                            slo_ttft_ms=args.slo_ttft_ms,
                            budget_tokens=args.class_budget_tokens)
    slo = None
    if args.slo_ttft_ms > 0:
        slo = SLOAdmission(cfg, sp=plan.sp_size, page_size=plan.page_size,
                           decode_batch=plan.decode_batch,
                           kernel=plan.kernel_impl,
                           calibration=args.slo_calibration)
    orch = Orchestrator(replicas, classes=classes, slo=slo,
                        preempt=bool(args.preempt), registry=registry,
                        tracer=tracer)
    run_server(orch, host=args.host, port=args.port, worker_spec=spec,
               workers=workers)
    return {}


def _resolve_plan(args, say=print):
    """``(plan, plans, cfg)``; ``plans`` is the per-role list of a
    disaggregated gateway (``--roles`` or a ``{"plans": [...]}`` file),
    else None. With several replicas (``--replicas``, ``--roles``, or
    ``--workers`` under ``--http``) ``--devices`` is split evenly between
    them; 0 gives each one rank. ``say`` prints (the lead rank's)."""
    import json

    from repro_torch.configs import registry
    from repro_torch.plan import (ExecutionPlan, make_role_plans,
                                  make_serve_plan)

    get_cfg = registry.get_smoke if args.smoke else registry.get
    if args.plan:
        rec = json.loads(open(args.plan).read())
        if "plans" in rec:
            plans = [ExecutionPlan.from_dict(d) for d in rec["plans"]]
            for p in plans:
                p.check_runnable()
            say(f"[serve] loaded {len(plans)} role plans {args.plan}: "
                f"roles={[p.role for p in plans]}")
            return plans[0], plans, get_cfg(plans[0].arch)
        plan = ExecutionPlan.load(args.plan)
        plan.check_runnable()
        say(f"[serve] loaded plan {args.plan}")
        return plan, None, get_cfg(plan.arch)
    cfg = get_cfg(args.arch)
    roles = [r.strip() for r in (args.roles or "").split(",") if r.strip()]
    n_rep = len(roles) or max(args.replicas, 1)
    if args.devices % n_rep:
        raise ValueError(f"--devices {args.devices} does not split evenly "
                         f"over {n_rep} replicas")
    kw = dict(arch=args.arch, n_devices=args.devices // n_rep or 1,
              data=args.data, c=args.c, decode_batch=args.max_slots,
              page_size=args.page_size, max_len=args.max_len,
              kernel_impl=args.kernel, block_impl=args.kernel,
              prefix_cache=bool(args.prefix_cache),
              host_tier_bytes=args.host_tier_bytes)
    if roles:
        plans = make_role_plans(cfg, roles=roles, **kw)
        return plans[0], plans, cfg
    return make_serve_plan(cfg, replicas=n_rep, **kw), None, cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="architecture id (optional with --plan)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks, as --backend runs them, split evenly over "
                         "the gateway's replicas or the front end's workers "
                         "(0: one rank each; WORLD_SIZE under torchrun "
                         "with --backend gloo|nccl)")
    ap.add_argument("--backend", default="threads",
                    choices=["threads", "gloo", "nccl"],
                    help="ranks as ThreadMesh threads on the device, or as "
                         "processes over gloo or nccl (engine and --legacy)")
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
    # gateway knobs
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas on the card (gateway mode when "
                         "> 1); --devices is split evenly across them")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="block-hash prefix cache with copy-on-write page "
                         "reuse (gateway mode)")
    ap.add_argument("--host-tier-bytes", type=int, default=0,
                    help="pinned-host KV tier capacity per engine, bytes "
                         "(0 = off; prefix-cache evictions spill here and "
                         "later hits reload instead of prefilling again; "
                         "needs --prefix-cache)")
    ap.add_argument("--roles", default=None,
                    help="comma-separated replica roles for disaggregated "
                         "serving, e.g. 'prefill,decode': one engine per "
                         "role; overrides --replicas")
    ap.add_argument("--system-prompt-len", type=int, default=32,
                    help="shared prompt prefix length in gateway mode "
                         "(0 = fully independent prompts)")
    # HTTP front-end knobs (repro_torch.frontend; --http switches modes)
    ap.add_argument("--http", action="store_true",
                    help="serve an async HTTP/SSE front end instead of a "
                         "canned workload")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--workers", type=int, default=0,
                    help="engine worker processes behind the front end "
                         "(--devices is split evenly across them; 0 = one "
                         "in-process replica)")
    ap.add_argument("--priority-classes", default="interactive,batch",
                    help="comma-separated priority classes, highest "
                         "first; classes after the first are preemptible")
    ap.add_argument("--slo-ttft-ms", type=float, default=0.0,
                    help="TTFT SLO for the highest class, priced at "
                         "admission from plan.cost (0 = no SLO gate)")
    ap.add_argument("--class-budget-tokens", type=int, default=0,
                    help="outstanding-token budget for the highest class "
                         "(0 = unlimited)")
    ap.add_argument("--slo-calibration", type=float, default=1.0,
                    help="scale analytical seconds to this machine "
                         "(measured_step_s / analytical_step_s)")
    ap.add_argument("--preempt", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="preempt the worst preemptible stream when a "
                         "higher-priority request is stuck queued")
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--pages-per-shard", type=int, default=128)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prefill prompts in chunks of about this many "
                         "tokens (0: whole prompts)")
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
                         "request, engine and gateway spans here")
    args = ap.parse_args(argv)
    if not args.plan and not args.arch:
        ap.error("--arch is required (unless --plan carries it)")
    if args.http and args.workers > 1:
        # the ranks are split over the worker processes as over gateway
        # replicas; the resolved plan is then per worker
        args.replicas = args.workers

    import os

    from repro_torch.dist import procs

    processes = args.backend != "threads"
    # under torchrun every process runs main(): rank 0 speaks for them
    lead = not processes or not procs.joined() or os.environ["RANK"] == "0"
    say = print if lead else (lambda *a, **k: None)
    if processes:
        _refuse_on_processes(args)
    if processes and not args.plan:
        # fit the requested (data, SP) split to the ranks there are
        fit = procs.fit_mesh(args.devices or (
            int(os.environ["WORLD_SIZE"]) if procs.joined() else 1),
            args.data)
        say(f"[serve] plan_mesh: world={fit.world} data={fit.data} "
            f"model={fit.model} stranded={fit.stranded}")
        args.devices, args.data = fit.devices, fit.data
    plan, plans, cfg = _resolve_plan(args, say)
    say(f"[serve] plan: P_sp={plan.sp_size} scheme={plan.scheme} "
        f"C={plan.c} R={plan.r} data={plan.data} "
        f"kernel={plan.kernel_impl} block={plan.block_impl} "
        f"slots={plan.decode_batch} page={plan.page_size} "
        f"capacity={plan.seq_len} "
        f"replicas={len(plans) if plans else plan.replicas} "
        f"roles={[p.role for p in plans] if plans else [plan.role]} "
        f"prefix_cache={plan.prefix_cache} "
        f"host_tier_bytes={plan.host_tier_bytes} device={args.device} "
        f"backend={args.backend}")
    if args.save_plan and lead:
        if plans:
            import json
            import pathlib

            path = pathlib.Path(args.save_plan)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(
                {"plans": [p.to_dict() for p in plans]}, indent=2))
        else:
            path = plan.save(args.save_plan)
        print(f"[serve] plan saved -> {path}")
    if not args.legacy:
        from repro_torch.engine import paged_cache

        # the engine's refusal, before any worker or replica is built
        ok, why = paged_cache.supported(cfg)
        if not ok:
            raise NotImplementedError(
                f"repro_torch.launch.serve: {cfg.name}: {why}")
    if processes:
        _refuse_on_processes(args, plan, plans)
        return _processes_main(args, plan, cfg, lead)
    from repro_torch import obs

    registry = obs.Registry()
    tracer = obs.Tracer(enabled=bool(args.trace_out))
    if args.http:
        out = _frontend_main(args, plan, cfg, registry=registry,
                             tracer=tracer)
    elif args.legacy:
        if plans or plan.replicas > 1:
            raise NotImplementedError(
                "repro_torch.launch.serve --legacy serves one replica (on "
                "any number of ranks); the gateway serves several")
        out = _legacy_main(args, plan, cfg, args.device)
        _print_legacy(args, out)
    elif plans or plan.replicas > 1 or plan.prefix_cache:
        out = _gateway_main(args, plan, cfg, args.device, registry=registry,
                            tracer=tracer, plans=plans)
    else:
        out, metrics = _engine_main(args, plan, args.device,
                                    registry=registry, tracer=tracer)
        _print_engine(args, cfg, out, metrics)
    for line in _write_dumps(args, registry, tracer):
        print(line)
    if args.comm_report:
        from repro_torch.engine.engine import resolve_device
        from repro_torch.obs import commlog

        _write_comm_report(args, commlog.comm_report(
            cfg, plan, device=resolve_device(args.device)))
    return out


def _write_dumps(args, registry, tracer):
    """Write ``--metrics-dump`` and ``--trace-out``; the lines that say
    so."""
    lines = []
    if args.metrics_dump:
        fmt = "json" if args.metrics_dump.endswith(".json") else "prometheus"
        registry.dump(args.metrics_dump, fmt=fmt)
        lines.append(f"[serve] metrics dump -> {args.metrics_dump} ({fmt})")
    if args.trace_out:
        tracer.dump(args.trace_out)
        lines.append(f"[serve] trace ({len(tracer.events())} events) -> "
                     f"{args.trace_out}")
    return lines


def _write_comm_report(args, rep) -> None:
    import json
    import pathlib

    path = pathlib.Path(args.comm_report)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rep, indent=2))
    ratios = {k: v["ratio"] for k, v in rep["per_collective"].items()}
    print(f"[serve] comm report -> {path} "
          f"within_tolerance={rep['within_tolerance']} ratios={ratios}")


# the half of ROADMAP.md §A item 1 a that rank processes do not serve yet
ON_THREADS_ONLY = (
    "the gateway (--replicas > 1, --roles, --prefix-cache) and the HTTP "
    "front end (--http, --workers) serve on ThreadMesh threads only: their "
    "replicas as rank processes are not ported yet (ROADMAP.md §A item 1 a, "
    "its remaining half: the gateway and front end on process replicas)")


def _refuse_on_processes(args, plan=None, plans=None) -> None:
    """Raise for what ``--backend gloo|nccl`` does not serve: the gateway
    and the front end (the flags, or a plan file's replicas and roles)."""
    gateway = (args.replicas > 1 or args.roles or plans
               or (plan is not None and plan.replicas > 1)
               or (args.prefix_cache and not args.legacy))
    if gateway or args.http or args.workers:
        raise NotImplementedError(
            f"repro_torch.launch.serve --backend {args.backend}: "
            f"{ON_THREADS_ONLY}")


def _processes_main(args, plan, cfg, lead: bool):
    """``--backend gloo|nccl``: the plan's ranks as processes, each running
    ``_serve_rank``; the lead (the spawning process, or rank 0 under
    ``torchrun``) prints rank 0's as ``--backend threads`` does. Returns
    the streams."""
    import torch

    from repro_torch.dist import procs
    from repro_torch.engine.engine import resolve_device

    if resolve_device(args.device).type == "cuda":
        from repro_torch.kernels import _build

        _build.library()           # one build, before the ranks load it
    mesh = procs.ProcessMesh(plan.c, plan.r, plan.data, plan.placement,
                             backend=args.backend, device=args.device)
    got = mesh.run(_serve_rank, plan, cfg, vars(args))
    if not got:                    # a rank plan_mesh stranded
        return {}
    res = got[0]
    out = (torch.tensor(res["out"], dtype=torch.int64) if args.legacy
           else res["out"])
    if lead:
        if args.legacy:
            _print_legacy(args, out)
        else:
            _print_engine(args, cfg, out, res["metrics"])
        for line in res["dumps"]:
            print(line)
        if args.comm_report:
            _write_comm_report(args, res["comm_report"])
    return out


def _serve_rank(comm, plan, cfg, opts):
    """One rank process of ``--backend gloo|nccl`` (module doc): its own
    shards of the model drawn from ``--seed`` on its device, its engine
    (or the static batch's steps on its rank) fed the same requests as
    every rank's, and ``--comm-report``'s island. Returns the streams and
    the engine's metrics (lists and numbers: every rank's are the same);
    rank 0 also writes the dumps, and returns their lines and the
    report."""
    import torch

    from repro_torch import obs
    from repro_torch.obs import commlog

    args = argparse.Namespace(**opts)
    device = (torch.device("cpu") if args.device == "cpu"
              else torch.device("cuda", torch.cuda.current_device()))
    lead = comm.rank == 0
    registry = obs.Registry()
    tracer = obs.Tracer(enabled=bool(args.trace_out) and lead)
    res = {}
    if args.legacy:
        res["out"] = _legacy_main(args, plan, cfg, device, comm).tolist()
    else:
        res["out"], res["metrics"] = _engine_main(
            args, plan, device, registry=registry, tracer=tracer, comm=comm)
    if args.comm_report:
        res["comm_report"] = commlog.comm_report(cfg, plan, device=device,
                                                 comm=comm)
    res["dumps"] = _write_dumps(args, registry, tracer) if lead else []
    return res


if __name__ == "__main__":
    main()
