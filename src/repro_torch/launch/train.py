"""End-to-end training entry point (the port's counterpart of
``repro.launch.train``): a plan from ``make_plan``, a seeded model, AdamW
and ``train.trainer.train`` on synthetic data.

Runs on the CUDA card by default and raises if there is none;
``--device cpu`` runs the plain PyTorch versions of the kernels:

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --smoke --device cpu --steps 4

Without ``--smoke`` the full-width model trains at the ``--shape`` sequence
length with the batch ``--batch``, 1 by default (one card: the published
shape's batch does not fit). The JAX launcher's other options raise ``NotImplementedError``
until their part is ported (ROADMAP.md).
"""

import argparse

# JAX launcher options that raise, with the ROADMAP.md item that ports them
_UNPORTED = {
    "--devices": "the multi-process SP communicator ('The main path', "
                 "item 3)",
    "--data": "the multi-process SP communicator ('The main path', item 3)",
    "--plan": "plan persistence and the cost model (§A)",
    "--autotune": "plan/autotune.py (§A)",
    "--ckpt-dir": "dist/checkpoint.py save / restore (§A)",
    "--microbatches": "gradient accumulation (§A)",
    "--scheme ulysses": "core/ulysses.py (§A)",
    "--multi-pod": "multi-pod meshes (§A)",
    "--metrics-dump": "the obs registry (§A)",
    "--trace-out": "the obs tracer (§A)",
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + the --seq-len/--batch shape")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default: the CUDA card (raises without one)")
    ap.add_argument("--c", type=int, default=1,
                    help="StarTrail C (one card: 1)")
    ap.add_argument("--scheme", default=None,
                    choices=["startrail", "ring", "ulysses"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=None,
                    help="default: 4 with --smoke, else 1 (the full width "
                         "takes ~34 GB at seq 4096 and batch 1 on one card)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--metrics", default=None)
    ap.add_argument("--seed", type=int, default=0)
    # the JAX launcher's other options, rejected until they are ported
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--plan", default=None)
    ap.add_argument("--autotune", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--metrics-dump", default=None)
    ap.add_argument("--trace-out", default=None)
    args = ap.parse_args(argv)
    for flag, on in (("--devices", args.devices > 1),
                     ("--data", args.data > 1),
                     ("--plan", bool(args.plan)),
                     ("--autotune", args.autotune),
                     ("--ckpt-dir", bool(args.ckpt_dir)),
                     ("--microbatches", args.microbatches > 1),
                     ("--scheme ulysses", args.scheme == "ulysses"),
                     ("--multi-pod", args.multi_pod),
                     ("--metrics-dump", bool(args.metrics_dump)),
                     ("--trace-out", bool(args.trace_out))):
        if on:
            raise NotImplementedError(
                f"repro_torch.launch.train {flag} is not ported yet: it "
                f"needs {_UNPORTED[flag]} (ROADMAP.md)")

    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPES, ShapeConfig
    from repro_torch.engine.engine import resolve_device
    from repro_torch.models.factory import build_model
    from repro_torch.optim import adamw
    from repro_torch.plan import make_plan
    from repro_torch.train import trainer as trainer_lib

    device = resolve_device(args.device)
    if args.smoke:
        cfg = registry.get_smoke(args.arch)
        shape = ShapeConfig("smoke", seq_len=args.seq_len,
                            global_batch=args.batch or 4, kind="train")
    else:
        cfg = registry.get(args.arch)
        shape = dataclasses.replace(SHAPES[args.shape],
                                    global_batch=args.batch or 1)
    plan = make_plan(cfg, shape, arch=args.arch, c=args.c,
                     scheme=args.scheme)
    print(f"[train] plan: P_sp={plan.sp_size} scheme={plan.scheme} "
          f"C={plan.c} R={plan.r} data={plan.data} seq={plan.seq_len} "
          f"batch={plan.global_batch} block={plan.block_impl} "
          f"device={device}")

    model = build_model(cfg, device=device, seed=args.seed)
    adam_cfg = adamw.AdamWConfig(learning_rate=args.lr, warmup_steps=5,
                                 decay_steps=max(args.steps, 10),
                                 state_dtype=cfg.opt_dtype)
    tcfg = trainer_lib.TrainerConfig(num_steps=args.steps, log_every=5,
                                     metrics_path=args.metrics,
                                     seed=args.seed)
    metrics = trainer_lib.train(model, plan, adam_cfg, tcfg, device=device)
    print(f"[train] done: {metrics}")
    return metrics


if __name__ == "__main__":
    main()
