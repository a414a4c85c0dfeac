"""Dry run: trace one (arch x shape x plan) cell's step on the meta device
(the port's counterpart of ``repro.launch.dryrun``, whose XLA AOT compile
this replaces). It needs no card.

For each cell the step of its kind runs once, the port's own step code on
tensors of the ``meta`` device (shapes and dtypes, no storage), on rank 0
of a ``dist.comm.TraceComm`` of the plan's mesh (that class's doc says
why one rank stands for every rank):

  train    ``train.step.build_train_step``: every rank's value and grad
           of the loss under the plan's sharding rules, the gradient
           reduction, then ``optim.adamw.apply`` on the rank's shards
  prefill  ``serve.step.build_prefill_step`` (with the frames as
           ``frontend_emb`` for the encoder-decoder, as JAX passes them)
  decode   ``serve.step.build_decode_step`` against the rank's
           ``serve.kv_cache.init_cache`` and (B, 1) tokens

and the record holds the JAX record's fields:

  flops_per_device   ``torch.utils.flop_counter.FlopCounterMode`` over the
                     step (its matmuls, convolutions and attention calls),
                     plus each kernel's own FLOPs under ``impl='cuda'``
                     (``kernels.meta``)
  bytes_accessed_per_device
                     every operator's tensor inputs and outputs, each
                     counted in full once per operator (the counterpart of
                     XLA's ``bytes accessed``): views, allocations of
                     uninitialised memory and the collectives (counted
                     under ``collectives``) move nothing; a kernel's meta
                     rule charges its own inputs and outputs
  collectives        the trace communicator's log, in the JAX HLO parse's
                     convention (``roofline.hlo.collective_bytes``): each
                     collective's result bytes per device, by XLA kind,
                     and the op count per kind (``count_by_kind_one_period``:
                     the one-period trace's); not the ledger's wire bytes
  memory             argument bytes (this rank's parameter shards, AdamW
                     state and batch, or its cache and tokens), output
                     bytes (the step's returns: updated parameters, state
                     and metrics; the next tokens and the cache), alias
                     bytes (the arguments the step updates in place:
                     parameters and AdamW state, the cache), temp bytes
                     (the peak of every other storage live during the step,
                     tracked storage by storage) and JAX's
                     ``peak = argument + output + temp - alias``
  compile_s          the full-depth trace's seconds

As in JAX, the per-step costs come from two shallow traces (one and two
layer periods) extrapolated to the full depth,
``cost(L) = cost(1) + (cost(2) - cost(1)) * (n_periods - 1)``, next to the
full-depth trace (``raw_full_depth``) that gives the memory. A trace
counts every iteration of every loop, so for a model of equal periods the
extrapolation equals the full-depth trace.

Kernels follow the plan: ``block_impl``/``kernel_impl = 'ref'`` traces the
plain versions (what the JAX records trace: their plans resolve to 'ref'
on the CPU); 'cuda' traces each kernel's meta rule. A plan that needs
several cards (``pod > 1``) records ``status: "error"`` naming ROADMAP.md
§A item 1, as the runnable paths raise it. Records go to
``results/repro_torch/dryrun/<name>.json`` with JAX's naming; the status
line says whether the peak fits the card's memory (``hw.HBM_BYTES``).

``--autotune`` instead runs the measured arrangement search
(``plan.autotune``) on a ``ThreadMesh`` of 8 ranks at the smoke config,
on the card unless ``--device cpu`` is given, persists the winner to
``results/repro_torch/PLAN_<arch>_smoke.json`` and fails unless the
chosen plan beats the worst candidate (JAX's pass rule).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch h2o-danube-1.8b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--c 2]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --autotune --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses as dc
import json
import pathlib
import time
import traceback
import weakref
from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.dist.comm import TraceComm
from repro_torch.kernels import meta
from repro_torch.models import spec, transformer
from repro_torch.models.factory import Model, shard_params
from repro_torch.optim import adamw
from repro_torch.plan import ExecutionPlan, make_plan
from repro_torch.roofline import hw

RESULTS = (pathlib.Path(__file__).resolve().parents[3] / "results"
           / "repro_torch" / "dryrun")

# operators that move no bytes: fresh uninitialised allocations (views
# are told apart by their schema)
_ALLOCATIONS = {"aten::empty", "aten::empty_strided", "aten::empty_like",
                "aten::new_empty", "aten::new_empty_strided"}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class _Counter(TorchDispatchMode):
    """Bytes accessed and the live bytes of the storages the step makes
    (module doc). Storages that exist before the trace (parameters,
    optimizer state, batch, cache) are the arguments and are not
    tracked."""

    def __init__(self, arguments):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._tag = object()
        for t in arguments:
            self._seen(t.untyped_storage())

    def _seen(self, st) -> bool:
        """Whether storage ``st`` is already tracked (marking it so)."""
        if getattr(st, "_dryrun_tag", None) is self._tag:
            return True
        st._dryrun_tag = self._tag
        return False

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = _tensors(out)
        if not func.is_view and func._schema.name not in _ALLOCATIONS:
            self.bytes += _nbytes(_tensors((args, kwargs))) + _nbytes(outs)
        for t in outs:
            st = t.untyped_storage()
            if not self._seen(st):
                n = st.nbytes()
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(st, self._free, n)
        return out


def _meta_model(cfg) -> Model:
    return Model(cfg, lambda s: torch.empty(
        s.shape, dtype=spec.DTYPES[s.dtype or cfg.param_dtype],
        device="meta"))


def _batch(cfg, shape) -> Dict[str, torch.Tensor]:
    """The global batch (``Model.input_specs`` of JAX) on the meta
    device."""
    b, s = shape.global_batch, shape.seq_len
    out = {n: torch.empty((b, s), dtype=torch.int32, device="meta")
           for n in ("tokens", "labels")}
    if cfg.frontend_stub is not None:
        out["frontend_emb"] = torch.empty(
            (b, s, cfg.d_model), dtype=spec.DTYPES[cfg.param_dtype],
            device="meta")
    return out


def _rows(n: int, data: int) -> int:
    """Rows of a batch of ``n`` each data replica serves (all of them
    when they do not split, as ``serve.step.StaticSteps`` does)."""
    return n // data if n % data == 0 else n


def _trace_once(model, plan, run_cfg, shape, cfg):
    """Run the step of ``shape.kind`` once on rank 0 of the plan's mesh,
    on the meta device. Returns (costs, memory) (module doc)."""
    from repro_torch.serve import kv_cache
    from repro_torch.serve import step as serve_step
    from repro_torch.train import step as train_step

    comm = TraceComm(plan.c, plan.r, plan.data, plan.pod, plan.placement)
    if plan.pod > 1:
        train_step.make_runtime(model, run_cfg, shape, comm)   # raises
    params = shard_params(model, comm, run_cfg.sharding_rules)
    p_bytes = _nbytes(params.named.values())
    dp, sp = plan.dp_size, plan.sp_size
    if shape.kind == "train":
        acfg = adamw.AdamWConfig(state_dtype=cfg.opt_dtype)
        step, sh = train_step.build_train_step(model, run_cfg, shape, acfg,
                                               comm)
        opt = adamw.init_state(sh["params"], acfg)
        batch = _batch(cfg, shape)
        # mu and nu of every shard in the state dtype, and the int32 step
        state = 2 * spec.DTYPES[cfg.opt_dtype].itemsize * sum(
            p.numel() for p in params.named.values()) + 4
        arg = p_bytes + state + _nbytes(batch.values()) // (dp * sp)
        arguments = list(sh["params"]) + opt["mu"] + opt["nu"] \
            + list(batch.values())

        def run():
            _, metrics = step(opt, batch)
            return metrics

        def outputs(metrics):
            return p_bytes + state + _nbytes(_tensors(metrics))
        alias = p_bytes + state
    elif shape.kind == "prefill":
        fn = serve_step.build_prefill_step(model, run_cfg, shape, comm)
        batch = {k: v for k, v in _batch(cfg, shape).items()
                 if k != "labels"}
        rows = _rows(shape.global_batch, plan.data)
        arg = p_bytes + sum(
            _nbytes([v]) // shape.global_batch * rows // sp
            for v in batch.values())
        arguments = list(model.parameters()) + list(batch.values())
        tokens = batch.get("tokens")

        def run():
            if cfg.encdec:
                return fn(batch["frontend_emb"])
            return fn(tokens, batch.get("frontend_emb"))

        def outputs(out):
            return _nbytes(_tensors(out))
        alias = 0
    else:  # decode
        fn = serve_step.build_decode_step(model, run_cfg, shape, comm)
        rows = _rows(shape.global_batch, plan.data)
        s_local = shape.seq_len // sp
        cache = kv_cache.init_cache(
            cfg, rows, s_local, "meta",
            enc_len=s_local if cfg.encdec else None)
        tokens = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                             device="meta")
        c_bytes = _nbytes(_tensors(cache))
        arg = p_bytes + c_bytes + _nbytes([tokens]) // shape.global_batch \
            * rows
        arguments = list(model.parameters()) + _tensors(cache) + [tokens]

        def run():
            # JAX compiles the step at cache_len = seq_len - 1
            cache_len = torch.full((shape.global_batch,), shape.seq_len - 1,
                                   dtype=torch.int32, device="meta")
            return fn([cache], tokens, cache_len)

        def outputs(tok):
            return _nbytes([tok]) + c_bytes
        alias = c_bytes

    charges = defaultdict(float)

    def sink(name, flops, nbytes):
        charges["flops"] += flops
        charges["bytes"] += nbytes

    counter = _Counter(arguments)
    flop_mode = FlopCounterMode(display=False)
    with meta.charging(sink), flop_mode, counter:
        out = run()
        out_bytes = outputs(out)
        del out
    coll = _collectives(comm)
    costs = {
        "flops": float(flop_mode.get_total_flops() + charges["flops"]),
        "bytes": float(counter.bytes + charges["bytes"]),
        "coll_total": float(coll["total_bytes"]),
        "coll_by_kind": coll["bytes_by_kind"],
        "coll_counts": coll["count_by_kind"],
    }
    memory = {"argument_bytes": arg, "output_bytes": out_bytes,
              "temp_bytes": counter.peak, "alias_bytes": alias}
    memory["peak_bytes_per_device"] = (
        memory["argument_bytes"] + memory["output_bytes"]
        + memory["temp_bytes"] - memory["alias_bytes"])
    return costs, memory


def trace_step(cfg, plan: ExecutionPlan):
    """(costs, memory) of one trace of ``plan``'s step at the width and
    depth of ``cfg``, whatever the plan's ``mesh_kind`` (module doc)."""
    return _trace_once(_meta_model(cfg), plan, plan.run_config(),
                       plan.shape_config(), cfg)


def _collectives(comm: TraceComm) -> Dict[str, object]:
    """The trace communicator's log in ``roofline.hlo.collective_bytes``'
    form."""
    by_bytes: Dict[str, int] = defaultdict(int)
    by_count: Dict[str, int] = defaultdict(int)
    for _, kind, nbytes, *_ in comm.log:
        by_bytes[kind] += nbytes
        by_count[kind] += 1
    return {"total_bytes": sum(by_bytes.values()),
            "bytes_by_kind": dict(by_bytes),
            "count_by_kind": dict(by_count)}


def plan_for_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                  c: int = 2, rules: str = "default",
                  remat: str = "attn_out",
                  placement: str = "team_inner") -> ExecutionPlan:
    """The production ExecutionPlan for one dry-run cell (JAX's: 256
    devices a pod, data 16). Its kernels resolve to 'cuda'
    (``kernels.dispatch.resolve_impl``: the meta rules), where the JAX
    records' plans resolve to 'ref' on the CPU; ``--plan`` replays any."""
    cfg = registry.get(arch)
    shape = SHAPES[shape_name]
    pod = 2 if multi_pod else 1
    return make_plan(cfg, shape, arch=arch, n_devices=256 * pod, data=16,
                     pod=pod, c=c, placement=placement, remat=remat,
                     sharding_rules=rules, mesh_kind="production")


def lower_cell(arch: str, shape_name: str, **plan_kw):
    """Trace one cell; the per-step costs by the two-point depth
    extrapolation of JAX's ``lower_cell`` (module doc)."""
    plan = plan_kw.pop("plan", None)
    if plan is not None:
        # replay: the plan carries the shape (also one outside SHAPES,
        # like 'smoke') and whether it was made on the smoke config
        cfg = (registry.get_smoke(arch) if plan.mesh_kind == "local"
               else registry.get(arch))
        shape = plan.shape_config()
    else:
        cfg = registry.get(arch)
        shape = SHAPES[shape_name]
    ok, why = registry.shape_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}

    if plan is None:
        plan = plan_for_cell(arch, shape_name, **plan_kw)
    run_cfg = plan.run_config()

    # ---- the full-depth trace: the cell runs, and its memory ----
    t0 = time.time()
    raw, mem = _trace_once(_meta_model(cfg), plan, run_cfg, shape, cfg)
    t_trace = time.time() - t0

    # ---- one and two periods, extrapolated to the full depth ----
    period = len(transformer.layer_pattern(cfg))
    n_periods = cfg.num_layers // period
    shallow = []
    for k in (1, 2):
        kcfg = dc.replace(cfg, num_layers=k * period)
        if cfg.encdec:
            kcfg = dc.replace(kcfg, num_encoder_layers=k)
        shallow.append(_trace_once(_meta_model(kcfg), plan, run_cfg, shape,
                                   kcfg)[0])
    c1, c2 = shallow

    def extrap(key):
        return c1[key] + (c2[key] - c1[key]) * (n_periods - 1)

    coll_by_kind = {}
    for kind in set(c1["coll_by_kind"]) | set(c2["coll_by_kind"]):
        a = c1["coll_by_kind"].get(kind, 0)
        b = c2["coll_by_kind"].get(kind, 0)
        coll_by_kind[kind] = a + (b - a) * (n_periods - 1)

    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if plan.pod > 1 else "16x16",
        "kind": shape.kind,
        "plan": plan.to_dict(),
        "c": plan.c,
        "rules": plan.sharding_rules,
        "remat": plan.remat,
        "placement": plan.placement,
        "devices": plan.n_devices,
        "n_periods": n_periods,
        "compile_s": round(t_trace, 1),
        "flops_per_device": extrap("flops"),
        "bytes_accessed_per_device": extrap("bytes"),
        "collectives": {
            "total_bytes": extrap("coll_total"),
            "bytes_by_kind": coll_by_kind,
            "count_by_kind_one_period": c1["coll_counts"],
        },
        "raw_full_depth": raw,
        "shallow": {"k1": c1, "k2": c2},
        "memory": mem,
    }


def fits(rec) -> bool:
    """Whether the record's peak fits one card's memory."""
    return rec["memory"]["peak_bytes_per_device"] <= hw.HBM_BYTES


def run_and_save(arch, shape_name, **kw):
    RESULTS.mkdir(parents=True, exist_ok=True)
    tag = "multi" if kw.get("multi_pod") else "single"
    c = kw.get("c", 2)
    name = f"{arch}__{shape_name}__{tag}__c{c}"
    if kw.get("rules", "default") != "default":
        name += f"__{kw['rules']}"
    if kw.get("placement", "team_inner") != "team_inner":
        name += f"__{kw['placement']}"
    if kw.get("remat", "attn_out") != "attn_out":
        name += f"__remat_{kw['remat']}"
    out = RESULTS / f"{name}.json"
    try:
        rec = lower_cell(arch, shape_name, **kw)
        rec["status"] = "skipped" if rec.get("skipped") else "ok"
    except Exception as e:  # noqa: BLE001 (recorded, as JAX records it)
        kw_rec = {k: (v.to_dict() if isinstance(v, ExecutionPlan) else v)
                  for k, v in kw.items()}
        rec = {"arch": arch, "shape": shape_name, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-3000:], **kw_rec}
    out.write_text(json.dumps(rec, indent=2))
    status = rec["status"]
    extra = ""
    if status == "ok":
        gb = rec["memory"]["peak_bytes_per_device"] / 2**30
        extra = (f" peak={gb:.2f}GiB/dev "
                 f"{'fits' if fits(rec) else 'exceeds'} "
                 f"{hw.HBM_BYTES / 2**30:.0f}GiB"
                 f" flops={rec['flops_per_device']:.3g}"
                 f" compile={rec['compile_s']}s")
    print(f"[{status}] {name}{extra}", flush=True)
    return rec


def run_autotune(arch: str, *, seq_len: int = 64, batch: int = 4,
                 data: int = 1, steps: int = 3, device=None):
    """Measured arrangement search on a ``ThreadMesh`` of 8 ranks (JAX's
    8 forced host devices) at the smoke config (JAX's CI ``plan-smoke``
    job).

    Fails (SystemExit) unless the chosen plan beats the worst measured
    candidate: the tuner must never hand back the slowest arrangement of
    the ones it timed."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.plan import autotune as autotune_lib

    cfg = registry.get_smoke(arch)
    shape = ShapeConfig("smoke", seq_len=seq_len, global_batch=batch,
                        kind="train")
    out = autotune_lib.autotune(cfg, shape, arch=arch, n_devices=8,
                                data=data, steps=steps, device=device)
    for e in out["measured"]:
        print(f"[autotune] {e['arrangement'].key:24s} "
              f"measured={e['measured_s'] * 1e3:8.2f}ms "
              f"analytical={e['analytical_s'] * 1e6:8.1f}us", flush=True)
    best, worst = out["measured"][0], out["measured"][-1]
    print(f"[autotune] winner={best['arrangement'].key} -> {out['path']}")
    # the in-memory winner is the measured best by construction, so check
    # what can break: the persisted plan must read back as that winner,
    # and it must strictly beat the analytical-worst anchor (a tie means
    # the timing degenerated)
    if ExecutionPlan.load(out["path"]) != best["plan"]:
        raise SystemExit("persisted plan is not the measured winner")
    if len(out["measured"]) > 1 and \
            not best["measured_s"] < worst["measured_s"]:
        raise SystemExit(
            "autotuned pick does not beat the worst measured candidate "
            f"({best['measured_s']:.6f}s vs {worst['measured_s']:.6f}s)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--c", type=int, default=2)
    ap.add_argument("--rules", default="default")
    ap.add_argument("--remat", default="attn_out")
    ap.add_argument("--placement", default="team_inner")
    ap.add_argument("--plan", default=None,
                    help="replay a persisted ExecutionPlan json for the cell")
    ap.add_argument("--autotune", action="store_true",
                    help="measured arrangement search on a ThreadMesh of "
                         "the smoke config")
    ap.add_argument("--device", default=None,
                    help="--autotune's device (default: the card)")
    args = ap.parse_args(argv)

    if args.autotune:
        return run_autotune(args.arch or "h2o-danube-1.8b",
                            device=args.device)

    plan = ExecutionPlan.load(args.plan) if args.plan else None
    cells = []
    if args.all:
        for a in registry.ASSIGNED_ARCHS:
            for sname in SHAPES:
                cells.append((a, sname))
    else:
        cells.append((args.arch or (plan and plan.arch),
                      args.shape or (plan and plan.shape)))

    meshes_to_run = [args.multi_pod]
    if args.both_meshes:
        meshes_to_run = [False, True]

    n_bad = 0
    recs = []
    for mp in meshes_to_run:
        for a, sname in cells:
            kw = dict(plan=plan) if plan else dict(
                multi_pod=mp, c=args.c, rules=args.rules, remat=args.remat,
                placement=args.placement)
            rec = run_and_save(a, sname, **kw)
            recs.append(rec)
            if rec.get("status") == "error":
                n_bad += 1
    if n_bad:
        raise SystemExit(f"{n_bad} cells failed")
    return recs


if __name__ == "__main__":
    main()
