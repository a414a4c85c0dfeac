"""repro_torch.obs and plan.cost vs the JAX package, and the per-collective
byte accounting against the paper's eqs. 2-4.

* The port's ``Registry`` renders the same Prometheus text and JSON as
  ``repro.obs.Registry`` after the same counter operations, and both parse
  it back the same (``parse_prometheus``).
* ``Tracer``: spans nest and dump valid Chrome JSON; the disabled tracer
  records nothing.
* ``plan.cost``: ``comm_volumes`` equals the JAX dict for ring, StarTrail
  and Ulysses at several (P, C); ``enumerate_arrangements`` and
  ``num_attention_layers`` equal the JAX ones.
* ``comm_report`` on ``ThreadMesh`` islands (the ``check_commlog_c2``
  mirror): C = 2, P = 8 reads ratio 1.0 on all-gather, collective-permute
  and reduce-scatter; Ulysses 1.0 on all-to-all; the ring (C = 1) 1.0
  against the port's ``island_wire_volumes``, exactly one K/V chunk below
  the JAX island's; each kind's ``eqs_bytes`` is the JAX
  ``analytical_wire_volumes``; a chunked ring moves the same bytes.
* ``CommLog.record_step`` ticks the counters by ``per_step x steps``.
* ``launch.train --scheme ulysses|ring|startrail --comm-chunks 2`` on a
  ThreadMesh on the CPU, with ``--metrics-dump`` and ``--trace-out``.
"""

import dataclasses
import json

import numpy as np
import pytest

from repro import obs as jax_obs
from repro.configs import registry as jax_registry
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.obs import commlog as jax_commlog
from repro.plan import cost as jax_cost
from repro.plan.plan import ExecutionPlan as JaxPlan
from repro_torch import obs
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.obs import commlog
from repro_torch.plan import cost, make_plan

ARCH = "h2o-danube-1.8b"


def _drive(mod):
    """One sequence of counter operations on module ``mod``'s registry."""
    reg = mod.Registry()
    c = reg.counter("requests_total", "requests served")
    c.inc(model="a")
    c.inc(2.5, model="a")
    c.inc(3, model='b"\\x\nend')
    reg.counter("comm_steps_total").inc()
    reg.counter("comm_bytes_total").inc(1.5e9, collective="all-gather")
    reg.counter("comm_bytes_total").inc(0.25, collective="all-to-all")
    return reg


def test_registry_renders_and_parses_as_the_jax_one(tmp_path):
    mine, theirs = _drive(obs), _drive(jax_obs)
    text = mine.render_prometheus()
    assert text == theirs.render_prometheus()
    assert json.dumps(mine.to_json(), sort_keys=True) == json.dumps(
        theirs.to_json(), sort_keys=True)
    parsed = obs.parse_prometheus(text)
    assert parsed == jax_obs.parse_prometheus(text)
    assert parsed[("requests_total", (("model", 'b"\\x\nend'),))] == 3
    assert mine.value("requests_total", model="a") == 3.5
    assert mine.get("comm_bytes_total").value(collective="all-to-all") \
        == 0.25
    with pytest.raises(ValueError, match="cannot decrease"):
        mine.counter("requests_total").inc(-1)
    for fmt, name in (("prometheus", "m.prom"), ("json", "m.json")):
        mine.dump(tmp_path / name, fmt=fmt)
        theirs.dump(tmp_path / f"j_{name}", fmt=fmt)
        assert (tmp_path / name).read_text() == \
            (tmp_path / f"j_{name}").read_text()


def test_tracer_spans_nest_and_dump_chrome_json(tmp_path):
    tr = obs.Tracer(enabled=True, annotate=True)
    with tr.span("train/step", cat="train", step=1):
        with tr.span("inner"):
            pass
    path = tmp_path / "t.json"
    tr.dump(path)
    events = json.loads(path.read_text())["traceEvents"]
    assert [e["ph"] for e in events] == ["X", "X"]
    inner, outer = events
    assert (inner["name"], outer["name"]) == ("inner", "train/step")
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert outer["args"] == {"step": 1} and "args" not in inner
    off = obs.Tracer(enabled=False)
    with off.span("x"):
        pass
    assert off.events() == []
    assert obs.NULL_TRACER.span("a") is obs.NULL_TRACER.span("b")


@pytest.mark.parametrize("sp", [4, 8, 16, 32])
def test_comm_volumes_match_jax(sp):
    cfg = registry.get(ARCH)
    cfg_j = jax_registry.get(ARCH)
    for seq, batch in ((4096, 1), (65536, 2)):
        shape = ShapeConfig("t", seq, batch, "train")
        shape_j = JaxShapeConfig("t", seq, batch, "train")
        arrs = cost.enumerate_arrangements(cfg, sp)
        assert [a.key for a in arrs] == [
            a.key for a in jax_cost.enumerate_arrangements(cfg_j, sp)]
        if sp <= 8:
            assert arrs[-1].scheme == "ulysses"
        for arr in arrs:
            arr_j = jax_cost.Arrangement(arr.scheme, arr.c, arr.r,
                                         arr.placement)
            for db in (2, 4):
                assert cost.comm_volumes(
                    cfg, shape, sp, arr, dtype_bytes=db) == \
                    jax_cost.comm_volumes(cfg_j, shape_j, sp, arr_j,
                                          dtype_bytes=db)
    assert cost.num_attention_layers(cfg) == \
        jax_cost.num_attention_layers(cfg_j) == 24


def _plans(scheme, c, seq=64):
    cfg = registry.get_smoke(ARCH)
    if scheme == "ulysses":         # head counts Ulysses can shard at P=8
        cfg = dataclasses.replace(cfg, num_heads=8, num_kv_heads=8)
    # placement and chunks pinned, not the ranking's pick, so the island's
    # counts stay those the JAX plan below is built with
    plan = make_plan(cfg, ShapeConfig("test", seq, 1, "train"),
                     n_devices=8, scheme=scheme, c=c,
                     placement="team_inner", comm_chunks=1)
    plan_j = JaxPlan(arch=ARCH, shape="test", seq_len=seq, global_batch=1,
                     n_devices=8, scheme=scheme, c=c,
                     seq_scheme=plan.seq_scheme)
    return cfg, plan, plan_j


@pytest.mark.parametrize("scheme,c,live", [
    ("startrail", 2, {"all-gather", "collective-permute", "reduce-scatter"}),
    ("ring", 1, {"collective-permute"}),
    ("ulysses", 1, {"all-to-all"})])
def test_comm_report_reads_one_on_every_live_kind(scheme, c, live):
    cfg, plan, plan_j = _plans(scheme, c)
    rep = commlog.comm_report(cfg, plan, device="cpu")
    assert rep["within_tolerance"] and rep["ranks_agree"], rep
    rows = rep["per_collective"]
    assert {k for k, row in rows.items() if row["analytical_bytes"]} == live
    for kind in live:
        assert rows[kind]["ratio"] == 1.0, (kind, rows[kind])
    # the closed form beside the island, as the JAX module prices it
    eqs = jax_commlog.analytical_wire_volumes(cfg, plan_j, dtype_bytes=2)
    assert {k: row["eqs_bytes"] for k, row in rows.items()} == eqs
    # the port's island against the JAX one (f32 wire bytes, as the JAX
    # module prices on the CPU)
    mine = commlog.island_wire_volumes(cfg, plan, dtype_bytes=4)
    theirs = jax_commlog.island_wire_volumes(cfg, plan_j)
    chunk = 2 * (c * 64 // 8) * cfg.num_kv_heads * cfg.head_dim_ * 4
    for kind in commlog.KIND_FROM_COMPONENTS:
        want = theirs[kind] - (chunk if (kind == "collective-permute"
                                         and c == 1 and scheme == "ring")
                               else 0)
        assert mine[kind] == want, kind
    assert commlog.analytical_wire_volumes(cfg, plan, dtype_bytes=4) == \
        jax_commlog.analytical_wire_volumes(cfg, plan_j, dtype_bytes=4)
    # the lse combine's all-reduces are reported, not gated
    assert (rep["unmodelled_allreduce_bytes"] > 0) == (scheme == "startrail")


def test_chunked_island_moves_the_same_bytes():
    cfg, plan, _ = _plans("startrail", 2)
    base = commlog.comm_report(cfg, plan, device="cpu")
    rep = commlog.comm_report(cfg, dataclasses.replace(plan, comm_chunks=4),
                              device="cpu")
    assert rep["per_collective"] == base["per_collective"]
    assert rep["within_tolerance"] and rep["arrangement"]["comm_chunks"] == 4
    assert rep["collective_counts"]["collective-permute"] == \
        base["collective_counts"]["collective-permute"] * 4 - 3 * 2


def test_commlog_record_step_ticks_per_step_times_steps():
    cfg, plan, _ = _plans("startrail", 2)
    reg = obs.Registry()
    log = commlog.CommLog(reg, cfg, plan, batch=2)
    per_layer = commlog.analytical_wire_volumes(cfg, plan, batch=2,
                                                dtype_bytes=4)
    mult = cost.num_attention_layers(cfg) * log.TRAIN_STEP_MULTIPLIER
    assert log.per_step == {k: v * mult for k, v in per_layer.items()}
    for _ in range(3):
        log.record_step()
    counter = reg.get("comm_bytes_total")
    for kind, v in log.per_step.items():
        if v:
            assert counter.value(collective=kind) == v * 3, kind
    assert reg.value("comm_steps_total") == 3


@pytest.mark.parametrize("flags,want", [
    (["--data", "4", "--scheme", "ulysses"], "P_sp=2 scheme=ulysses C=1"),
    (["--data", "2", "--scheme", "ring"], "P_sp=4 scheme=ring C=1 R=4"),
    (["--data", "1", "--c", "2", "--comm-chunks", "2"],
     "P_sp=8 scheme=startrail C=2 R=2")])
def test_launch_train_schemes_with_metrics_and_trace(tmp_path, capsys,
                                                     flags, want):
    from repro_torch.launch import train

    prom, trace = tmp_path / "m.prom", tmp_path / "t.json"
    metrics = tmp_path / "m.jsonl"
    out = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--devices", "8", "--steps", "3", "--metrics",
                      str(metrics), "--metrics-dump", str(prom),
                      "--trace-out", str(trace)] + flags)
    assert want in capsys.readouterr().out
    assert out["step"] == 3
    losses = [json.loads(x)["loss"] for x in metrics.read_text().splitlines()]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    series = obs.parse_prometheus(prom.read_text())
    assert series[("comm_steps_total", ())] == 3
    kind = "all-to-all" if "ulysses" in flags else "collective-permute"
    for phase in ("forward", "backward"):
        assert series[("comm_ledger_bytes_total",
                       (("collective", kind), ("pass", phase)))] > 0
    names = [e["name"] for e in json.loads(trace.read_text())["traceEvents"]]
    assert names.count("train/step") == 3 and names.count("train/data") == 3


def test_launch_train_ulysses_beyond_the_head_counts_raises():
    from repro_torch.launch import train

    # the smoke model's 2 kv heads do not divide P = 4
    with pytest.raises(ValueError, match="head counts divisible"):
        train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--devices", "8", "--data", "2", "--scheme", "ulysses"])
