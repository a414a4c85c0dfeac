"""End-to-end training entry point (the port's counterpart of
``repro.launch.train``): a plan from ``make_plan``, a seeded model, AdamW
and ``train.trainer.train`` on synthetic data.

Runs on the CUDA card by default and raises if there is none;
``--device cpu`` runs the plain PyTorch versions of the kernels:

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --smoke --device cpu --steps 4

Without ``--smoke`` the full-width model trains at the ``--shape`` sequence
length with the batch ``--batch``, 1 by default (one card: the published
shape's batch does not fit). ``--microbatches M`` accumulates gradients
over M slices of the batch; ``--ckpt-dir D`` checkpoints every
``max(steps // 2, 1)`` steps into ``D`` and, run again, resumes from the
newest checkpoint there (as the JAX launcher does).

``--devices N --data D --c C`` trains on N ranks: D data replicas of
P = N / D sequence-parallel ranks factored as (C, R, C), run as the
threads of a ``ThreadMesh`` on the chosen device (the counterpart of the
JAX launcher's forced host devices; ``--placement`` maps threads to
coordinates and changes no value):

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --smoke --device cpu --devices 8 --data 2 --c 2 --steps 3

``--rules`` picks the sharding rule set each rank stores its parameter
shards under (``dist.sharding``: 'default', 'fsdp' or 'tp'; written into
the plan, and read back from a ``--plan`` file):

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --smoke --device cpu --devices 8 --data 2 --c 2 --rules tp --steps 3

``--scheme`` picks the attention: 'startrail', 'ring' (C = 1) or 'ulysses'
(all-to-all; P must divide the head counts); ``--comm-chunks`` splits each
ring transfer into sub-chunks and ``--no-pipeline`` issues each ring
transfer after the block kernel instead of before it (neither changes a
value; ``core.startrail``, the JAX launcher's flags). Knobs left unset
(``--c``, ``--scheme``, ``--placement``, ``--comm-chunks``) are the
analytical cost model's pick (``plan.make_plan``), as in the JAX launcher.

``--autotune`` times the analytical top 3 arrangements (and the worst) for
a few steps each, writes the winner to
``results/repro_torch/PLAN_<arch>_<shape>.json`` and trains it; ``--plan
FILE`` trains a persisted plan (arch, shape, devices and arrangement from
the file, the port's or the JAX package's; ``--smoke`` still picks the
smoke width):

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --smoke --device cpu --devices 4 --autotune --steps 2
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --plan results/repro_torch/PLAN_h2o-danube-1.8b_smoke.json --steps 2

``--metrics-dump PATH`` writes the ``obs`` registry after
the run (Prometheus text, or JSON for a ``.json`` path): the per-step
analytical bytes per collective of ``obs.commlog.CommLog`` and the bytes
the communicator counted (the whole step: the rules' parameter gathers,
run again in the recompute, and gradient reductions among them); ``--trace-out PATH`` writes a Chrome trace of
the loop's train/data, train/step and train/ckpt spans:

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --smoke --device cpu --devices 8 --data 4 --scheme ulysses --steps 3 \\
      --metrics-dump "$TMPDIR/m.prom" --trace-out "$TMPDIR/trace.json"

``--backend gloo|nccl`` runs the ``--devices N`` ranks as processes
(``dist.procs.ProcessMesh``: one ``dist.comm.ProcessComm`` each, the
plan's arrangement) instead of threads (``--backend threads``, the
default). Every rank builds the whole model on the host from ``--seed``
and keeps its shards on its device (``factory.rank_model``), so its
weights are those of ``--backend threads --device cpu``; rank 0 prints,
writes ``--metrics``, ``--metrics-dump``, ``--trace-out`` and the
checkpoints. ``dist.elastic.plan_mesh`` fits the requested (data, model)
split to the ranks there are. gloo runs on the CPU, or several ranks on
one card; nccl takes one card per rank:

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --smoke --device cpu --backend gloo --devices 4 --steps 2
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch h2o-danube-1.8b --smoke --backend nccl --devices 4 --steps 2

Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) each process joins as
one rank, and the world size is ``WORLD_SIZE``.

The JAX launcher's ``--multi-pod`` raises ``NotImplementedError`` until its
part is ported (ROADMAP.md §A item 1 b, the pod axis).
"""

import argparse
import os

from repro_torch.dist.sharding import RULES


def _train_rank(comm, plan, cfg, opts):
    """One rank process of ``--backend gloo|nccl``: the model built on the
    host from the seed, this rank's shards kept on its device, then the
    trainer on this rank. Returns rank 0's last metrics (None elsewhere)."""
    import torch

    from repro_torch import obs
    from repro_torch.models.factory import build_model, rank_model
    from repro_torch.train import trainer as trainer_lib

    device = (torch.device("cpu") if opts["device"] == "cpu"
              else torch.device("cuda", torch.cuda.current_device()))
    model = rank_model(build_model(cfg, device="cpu", seed=opts["seed"]),
                       comm, plan.sharding_rules, device)
    lead = comm.rank == 0
    registry = obs.Registry() if opts["metrics_dump"] and lead else None
    tracer = (obs.Tracer(enabled=True, annotate=True)
              if opts["trace_out"] and lead else None)
    metrics = trainer_lib.train(
        model, plan, _adam_cfg(cfg, opts), _trainer_cfg(opts), device=device,
        tracer=tracer, registry=registry, comm=comm)
    if lead:
        _dump(opts, registry, tracer)
    return metrics if lead else None


def _adam_cfg(cfg, opts):
    from repro_torch.optim import adamw

    return adamw.AdamWConfig(learning_rate=opts["lr"], warmup_steps=5,
                             decay_steps=max(opts["steps"], 10),
                             state_dtype=cfg.opt_dtype)


def _trainer_cfg(opts):
    from repro_torch.train import trainer as trainer_lib

    return trainer_lib.TrainerConfig(
        num_steps=opts["steps"], log_every=5,
        ckpt_every=max(opts["steps"] // 2, 1), ckpt_dir=opts["ckpt_dir"],
        metrics_path=opts["metrics"], seed=opts["seed"])


def _dump(opts, registry, tracer) -> None:
    if opts["metrics_dump"]:
        path = opts["metrics_dump"]
        fmt = "json" if path.endswith(".json") else "prometheus"
        registry.dump(path, fmt=fmt)
        print(f"[train] metrics dump -> {path} ({fmt})")
    if opts["trace_out"]:
        tracer.dump(opts["trace_out"])
        print(f"[train] trace ({len(tracer.events())} events) -> "
              f"{opts['trace_out']}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="architecture id (optional with --plan)")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + the --seq-len/--batch shape")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default: the CUDA card (raises without one)")
    ap.add_argument("--c", type=int, default=None,
                    help="StarTrail C (default: cost-model pick)")
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks (default: WORLD_SIZE under torchrun, else "
                         "1), as --backend runs them")
    ap.add_argument("--backend", default="threads",
                    choices=["threads", "gloo", "nccl"],
                    help="ranks as ThreadMesh threads on the device, or as "
                         "processes over gloo or nccl")
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel replicas (divides --devices)")
    ap.add_argument("--placement", default=None,
                    choices=["team_inner", "ring_inner"])
    ap.add_argument("--scheme", default=None,
                    choices=["startrail", "ring", "ulysses"])
    ap.add_argument("--rules", default="default", choices=sorted(RULES),
                    help="sharding rule set of the parameter shards")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=None,
                    help="default: 4 with --smoke, else 1 (the full width "
                         "takes ~34 GB at seq 4096 and batch 1 on one card)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--metrics", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=None,
                    help="grad-accumulation microbatches (default: 1)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint here; resume from it when it holds one")
    ap.add_argument("--comm-chunks", type=int, default=None,
                    help="ring-transfer sub-chunks (default: overlap-model "
                         "pick; must divide the team sequence length C*N/P)")
    ap.add_argument("--metrics-dump", default=None,
                    help="write the obs registry (per-collective comm "
                         "bytes) here after the run (Prometheus text; "
                         ".json suffix -> JSON)")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome-trace JSON of the train/data, "
                         "train/step and train/ckpt spans here")
    ap.add_argument("--plan", default=None,
                    help="train a persisted ExecutionPlan json")
    ap.add_argument("--autotune", action="store_true",
                    help="measure the analytical top-k and train the winner")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="issue each ring transfer after the block kernel "
                         "(default: before it, pipelined)")
    # the JAX launcher's last option, rejected until it is ported
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    if not args.plan and not args.arch:
        ap.error("--arch is required (unless --plan carries it)")
    if args.multi_pod:
        raise NotImplementedError(
            "repro_torch.launch.train --multi-pod is not ported yet: it "
            "needs multi-pod meshes (§A item 1 b, the pod axis) "
            "(ROADMAP.md)")

    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPES, ShapeConfig
    from repro_torch.dist import procs
    from repro_torch.engine.engine import resolve_device
    from repro_torch.launch.mesh import refinable_grids
    from repro_torch import obs
    from repro_torch.models.factory import build_model
    from repro_torch.plan import ExecutionPlan, make_plan
    from repro_torch.plan import autotune as autotune_lib
    from repro_torch.train import trainer as trainer_lib

    processes = args.backend != "threads"
    # under torchrun every process runs main(): rank 0 speaks for them
    lead = not procs.joined() or os.environ["RANK"] == "0"
    if args.devices is None:
        args.devices = (int(os.environ["WORLD_SIZE"]) if procs.joined()
                        and processes else 1)
    if processes and not args.plan:
        # fit the requested (data, model) split to the ranks there are
        fit = procs.fit_mesh(args.devices, args.data)
        if lead:
            print(f"[train] plan_mesh: world={fit.world} data={fit.data} "
                  f"model={fit.model} stranded={fit.stranded}")
        args.devices, args.data = fit.devices, fit.data
    device = resolve_device(args.device)
    get_cfg = registry.get_smoke if args.smoke else registry.get
    if args.plan:
        plan = ExecutionPlan.load(args.plan)
        plan.check_runnable()
        cfg = get_cfg(plan.arch)
        print(f"[train] loaded plan {args.plan}")
    else:
        cfg = get_cfg(args.arch)
        if args.smoke:
            shape = ShapeConfig("smoke", seq_len=args.seq_len,
                                global_batch=args.batch or 4, kind="train")
        else:
            shape = dataclasses.replace(SHAPES[args.shape],
                                        global_batch=args.batch or 1)
    if args.autotune and not args.plan:
        tuned = autotune_lib.autotune(
            cfg, shape, arch=args.arch, n_devices=args.devices,
            data=args.data, microbatches=args.microbatches, device=device,
            seed=args.seed)
        plan = tuned["plan"]
        for e in tuned["measured"]:
            print(f"[train] autotune {e['arrangement'].key}: measured "
                  f"{e['measured_s']:.4f} s/step, analytical "
                  f"{e['analytical_s']:.3e} s/layer")
        print(f"[train] autotuned plan -> {tuned['path']}")
    elif not args.plan:
        try:
            plan = make_plan(cfg, shape, arch=args.arch,
                             n_devices=args.devices, data=args.data,
                             c=args.c, scheme=args.scheme,
                             placement=args.placement,
                             microbatches=args.microbatches,
                             comm_chunks=args.comm_chunks,
                             pipeline_scan=not args.no_pipeline,
                             sharding_rules=args.rules)
        except ValueError as e:
            raise ValueError(
                f"{e}; legal (data, SP) grids with C = 2 for --devices "
                f"{args.devices}: {refinable_grids(args.devices)}") from e
    if lead:
        print(f"[train] plan: P_sp={plan.sp_size} scheme={plan.scheme} "
              f"C={plan.c} R={plan.r} data={plan.data} "
              f"placement={plan.placement} seq={plan.seq_len} "
              f"batch={plan.global_batch} "
              f"microbatches={plan.microbatches} remat={plan.remat} "
              f"block={plan.block_impl} comm_chunks={plan.comm_chunks} "
              f"pipeline={plan.pipeline_scan} rules={plan.sharding_rules} "
              f"device={device} backend={args.backend}")

    opts = {k: getattr(args, k) for k in (
        "device", "seed", "lr", "steps", "ckpt_dir", "metrics",
        "metrics_dump", "trace_out")}
    if processes:
        plan.check_runnable()
        if device.type == "cuda":
            from repro_torch.kernels import _build

            _build.library()       # one build, before the ranks load it
        mesh = procs.ProcessMesh(plan.c, plan.r, plan.data, plan.placement,
                                 backend=args.backend, device=args.device)
        metrics = next(iter(mesh.run(_train_rank, plan, cfg, opts)), None)
    else:
        model = build_model(cfg, device=device, seed=args.seed)
        registry = obs.Registry() if args.metrics_dump else None
        # annotate: each span is also a torch.profiler range
        tracer = (obs.Tracer(enabled=True, annotate=True) if args.trace_out
                  else None)
        metrics = trainer_lib.train(model, plan, _adam_cfg(cfg, opts),
                                    _trainer_cfg(opts), device=device,
                                    tracer=tracer, registry=registry)
        _dump(opts, registry, tracer)
    if lead:
        print(f"[train] done: {metrics}")
    return metrics


if __name__ == "__main__":
    main()
