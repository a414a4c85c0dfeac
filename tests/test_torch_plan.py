"""The port's planner against the JAX package's: the §3.4 topology
scheduler (``core/scheduler.py``), the cost model's training time half
(``plan/cost.py``), ``make_plan`` / ``make_serve_plan`` with the knobs left
open, plan files, the measured search (``plan/autotune.py``) and the
launcher's ``--autotune`` / ``--plan``.

Every function gets the same inputs in both packages: each JAX config (the
ten of ``ASSIGNED_ARCHS`` and the paper's GPT-3B, GPT-7B and DiT-1B) is
carried field by field into the port's ``ModelConfig``, and both get an
equal explicit ``ClusterModel`` holding the JAX table's constants. Keys and
ints must be equal, floats within 1e-12 relative. Last, the port's own H100 table (NVIDIA datasheet, H100 SXM5
80GB at 700 W) gives the ranking and the plan it should on full-width
h2o-danube-1.8b at P = 8.
"""

import dataclasses
import json
import math

import jax  # noqa: F401  (both frameworks share the test process)
import numpy as np
import pytest
import torch  # noqa: F401

from repro.configs import base as jax_base
from repro.configs import paper_models
from repro.configs import registry as jax_registry
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.core import scheduler as jax_sch
from repro.plan import autotune as jax_autotune
from repro.plan import cost as jax_cost
from repro.plan.plan import ExecutionPlan as JaxPlan
from repro.plan.plan import make_plan as jax_make_plan
from repro.plan.plan import make_role_plans as jax_make_role_plans
from repro.plan.plan import make_serve_plan as jax_make_serve_plan
from repro.roofline import hw as jax_hw

from repro_torch.configs import base as tbase
from repro_torch.configs import registry
from repro_torch.core import scheduler as sch
from repro_torch.models.factory import Model
from repro_torch.plan import (ExecutionPlan, autotune, cost, make_plan,
                              make_serve_plan, plan_path)
from repro_torch.roofline import hw

ARCH = "h2o-danube-1.8b"
REL = 1e-12
SPS = (1, 2, 4, 8, 16, 32)
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k")
CONFIGS = {**{a: jax_registry.get(a) for a in jax_registry.ASSIGNED_ARCHS},
           "gpt-3b": paper_models.GPT_3B, "gpt-7b": paper_models.GPT_7B,
           "dit-1b": paper_models.DIT_1B}


def _port_cfg(cfg_j):
    """The JAX ModelConfig carried field by field into the port's."""
    d = dataclasses.asdict(cfg_j)
    for key, cls in (("moe", tbase.MoEConfig), ("mamba", tbase.MambaConfig),
                     ("xlstm", tbase.XLSTMConfig)):
        if d[key] is not None:
            d[key] = cls(**d[key])
    return tbase.ModelConfig(**d)


def _shapes(name):
    s = JAX_SHAPES[name]
    return (tbase.ShapeConfig(s.name, s.seq_len, s.global_batch, s.kind), s)


def _clusters(sp):
    """An equal explicit ClusterModel in each package (the JAX defaults)."""
    return (sch.ClusterModel(sp_size=sp, peak_flops=jax_hw.PEAK_FLOPS_BF16,
                             link_bw=jax_hw.ICI_BW_PER_LINK),
            jax_sch.ClusterModel(sp_size=sp))


def _arr_key(a):
    return (a.scheme, a.c, a.r, a.placement)


def _same(got, want, where=""):
    """Keys, ints, strings and bools equal; floats within REL relative;
    Arrangements by their fields."""
    if isinstance(want, jax_cost.Arrangement):
        assert _arr_key(got) == _arr_key(want), where
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{where}[{i}]")
    elif isinstance(want, float) and not isinstance(got, bool):
        assert isinstance(got, float), (where, got)
        assert math.isclose(got, want, rel_tol=REL, abs_tol=0.0), \
            (where, got, want)
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


def _both(where, port_fn, jax_fn):
    """Call both; equal results, or the same exception type."""
    try:
        want = jax_fn()
    except (ValueError, ZeroDivisionError) as e:
        with pytest.raises(type(e)):
            port_fn()
        return None
    got = port_fn()
    _same(got, want, where)
    return got


# ---------------------------------------------------------------------------
# core/scheduler.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sname", SHAPE_NAMES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_scheduler_matches_jax(name, sname):
    cfg_j = CONFIGS[name]
    cfg = _port_cfg(cfg_j)
    shape, shape_j = _shapes(sname)

    def profile(c, placement):      # a stand-in for a measured step
        return 1.0 / c + (0.25 if placement == "team_inner" else 0.5)

    for sp in SPS:
        cl, cl_j = _clusters(sp)
        for batch in (1, shape.global_batch):
            w = cost._workload(cfg, shape, batch)
            w_j = jax_cost._workload(cfg_j, shape_j, batch)
            assert dataclasses.asdict(w) == dataclasses.asdict(w_j)
            for c in jax_sch.valid_c_values(sp):
                for pl in ("team_inner", "ring_inner"):
                    for f in (1.0, 0.5, 0.0):
                        for n in (1, 2, 4):
                            _both(f"{name} step P={sp} {sname} c={c}",
                                  lambda: sch.attention_step_cost(
                                      w, cl, c, pl, overlap_frac=f,
                                      comm_chunks=n),
                                  lambda: jax_sch.attention_step_cost(
                                      w_j, cl_j, c, pl, overlap_frac=f,
                                      comm_chunks=n))
                        _both(f"{name} chunks P={sp} c={c}",
                              lambda: sch.choose_comm_chunks(
                                  w, cl, c, pl, overlap_frac=f),
                              lambda: jax_sch.choose_comm_chunks(
                                  w_j, cl_j, c, pl, overlap_frac=f))
            _both(f"{name} schedule P={sp} {sname}",
                  lambda: sch.schedule(w, cl),
                  lambda: jax_sch.schedule(w_j, cl_j))
            _both(f"{name} profiled schedule P={sp}",
                  lambda: sch.schedule(w, cl, profile_fn=profile),
                  lambda: jax_sch.schedule(w_j, cl_j, profile_fn=profile))
    with pytest.raises(ValueError, match="overlap_frac"):
        sch.attention_step_cost(w, cl, 1, "team_inner", overlap_frac=1.5)
    with pytest.raises(ValueError, match="comm_chunks"):
        sch.attention_step_cost(w, cl, 1, "team_inner", comm_chunks=0)


# ---------------------------------------------------------------------------
# plan/cost.py: the training time half
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sname", SHAPE_NAMES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_training_cost_matches_jax(name, sname):
    cfg_j = CONFIGS[name]
    cfg = _port_cfg(cfg_j)
    shape, shape_j = _shapes(sname)
    for sp in SPS:
        cl, cl_j = _clusters(sp)
        arrs = cost.enumerate_arrangements(cfg, sp)
        arrs_j = jax_cost.enumerate_arrangements(cfg_j, sp)
        _same(arrs, arrs_j, f"{name} arrangements P={sp}")
        for batch in (None, 1):
            _both(f"{name} rank P={sp} {sname} b={batch}",
                  lambda: cost.rank_arrangements(
                      cfg, shape, sp, batch=batch, cluster=cl),
                  lambda: jax_cost.rank_arrangements(
                      cfg_j, shape_j, sp, batch=batch, cluster=cl_j))
            for a, a_j in zip(arrs, arrs_j):
                _both(f"{name} time P={sp} {a.key}",
                      lambda: cost.arrangement_time(
                          cfg, shape, sp, a, batch=batch, cluster=cl),
                      lambda: jax_cost.arrangement_time(
                          cfg_j, shape_j, sp, a_j, batch=batch,
                          cluster=cl_j))
                _both(f"{name} chunks P={sp} {a.key}",
                      lambda: cost.choose_comm_chunks(
                          cfg, shape, sp, a, batch=batch, cluster=cl),
                      lambda: jax_cost.choose_comm_chunks(
                          cfg_j, shape_j, sp, a_j, batch=batch,
                          cluster=cl_j))


# ---------------------------------------------------------------------------
# make_plan / make_serve_plan with the knobs left open
# ---------------------------------------------------------------------------

PLAN_FIELDS = ("scheme", "c", "placement", "r", "comm_chunks",
               "microbatches", "seq_scheme", "block_skip", "sp_size",
               "seq_len", "global_batch", "kind")


@pytest.mark.parametrize("n_devices,data", [(8, 1), (8, 2), (16, 1),
                                            (16, 2)])
def test_make_plan_resolves_as_jax(n_devices, data):
    for name, cfg_j in CONFIGS.items():
        cfg = _port_cfg(cfg_j)
        cl, cl_j = _clusters(n_devices // data)
        for sname in SHAPE_NAMES:
            shape, shape_j = _shapes(sname)
            for kw in ({}, {"c": 2}, {"c": 1}, {"scheme": "ring"},
                       {"c": 2, "placement": "team_inner"}):
                try:
                    want = jax_make_plan(cfg_j, shape_j, n_devices=n_devices,
                                         data=data, cluster=cl_j, **kw)
                except ValueError:
                    with pytest.raises(ValueError):
                        make_plan(cfg, shape, n_devices=n_devices,
                                  data=data, cluster=cl, **kw)
                    continue
                got = make_plan(cfg, shape, n_devices=n_devices, data=data,
                                cluster=cl, **kw)
                for f in PLAN_FIELDS:
                    assert getattr(got, f) == getattr(want, f), \
                        (name, sname, kw, f)
        serve = jax_make_serve_plan(cfg_j, n_devices=n_devices, data=data,
                                    cluster=cl_j, max_len=1000)
        got = make_serve_plan(cfg, n_devices=n_devices, data=data,
                              cluster=cl, max_len=1000)
        for f in PLAN_FIELDS + ("decode_batch", "page_size"):
            assert getattr(got, f) == getattr(serve, f), (name, f)


def test_make_plan_repairs_the_open_knobs():
    """Full-width h2o-danube-1.8b, train_4k at batch 1, P = 8, C = 2 with
    the placement and chunk count left open: the port once returned its
    defaults ('team_inner', 1); the ranking now gives JAX's pick."""
    cfg_j = jax_registry.get(ARCH)
    shape_j = dataclasses.replace(JAX_SHAPES["train_4k"], global_batch=1)
    want = jax_make_plan(cfg_j, shape_j, n_devices=8, c=2)
    assert (want.placement, want.comm_chunks) == ("ring_inner", 4)
    shape = tbase.ShapeConfig("train_4k", 4096, 1, "train")
    got = make_plan(registry.get(ARCH), shape, n_devices=8, c=2,
                    cluster=_clusters(8)[0])
    assert (got.scheme, got.c, got.placement, got.comm_chunks) == \
        ("startrail", 2, "ring_inner", 4)
    # an explicit knob still wins, and an illegal C names the legal ones
    pinned = make_plan(registry.get(ARCH), shape, n_devices=8, c=2,
                       placement="team_inner", comm_chunks=1)
    assert (pinned.placement, pinned.comm_chunks) == ("team_inner", 1)
    with pytest.raises(ValueError, match="invalid for P=8.*legal: "
                       r"\['ring', 'startrail_c2_ring_inner'"):
        make_plan(registry.get(ARCH), shape, n_devices=8, c=3)
    with pytest.raises(ValueError, match="no legal arrangement matches "
                       "scheme='ring' c=2"):
        make_plan(registry.get(ARCH), shape, n_devices=8, c=2,
                  scheme="ring")


def test_h100_table_ranks_as_predicted():
    """The port's own constants (NVIDIA datasheet, H100 SXM5 80GB, 700 W:
    989 TFLOP/s bf16, NVLink 450 GB/s each way): the per-layer ranking at
    P = 8, seq 4096, batch 1 on full-width h2o-danube-1.8b, and the plan
    ``make_plan(c=None)`` makes of it."""
    assert (hw.PEAK_FLOPS_BF16, hw.PEAK_FLOPS_F32, hw.HBM_BW,
            hw.NVLINK_BW) == (989e12, 67e12, 3.35e12, 450e9)
    cfg = registry.get(ARCH)
    shape = tbase.ShapeConfig("train_4k", 4096, 1, "train")
    ranking = cost.rank_arrangements(cfg, shape, 8)
    assert [(e["arrangement"].key, round(e["total_s"] * 1e6, 1))
            for e in ranking] == [("startrail_c2_ring_inner", 22.0),
                                  ("startrail_c2_team_inner", 22.9),
                                  ("ulysses", 25.6), ("ring", 49.1)]
    assert ranking[0]["model_s"] == ranking[0]["total_s"] * 24
    plan = make_plan(cfg, shape, arch=ARCH, n_devices=8)
    assert (plan.scheme, plan.c, plan.r, plan.placement,
            plan.comm_chunks, plan.microbatches) == \
        ("startrail", 2, 2, "ring_inner", 1, 1)
    serve = make_serve_plan(cfg, arch=ARCH)
    assert (serve.sp_size, serve.c, serve.scheme) == (1, 1, "ring")


# ---------------------------------------------------------------------------
# plan files
# ---------------------------------------------------------------------------

def _jax_plan_dict():
    cfg_j = jax_registry.get_smoke(ARCH)
    plan = jax_make_plan(cfg_j, JaxShapeConfig("smoke", 64, 4, "train"),
                         arch=ARCH, n_devices=8, data=2, c=2,
                         placement="ring_inner", block_impl="pallas",
                         kernel_impl="pallas", pipeline_scan=False,
                         grad_compression="int8", comm_chunks=2)
    return plan, plan.to_dict()


def test_plan_file_from_jax(tmp_path):
    plan_j, _ = _jax_plan_dict()
    path = plan_j.save(tmp_path / "PLAN_jax.json")
    got = ExecutionPlan.load(path)
    assert (got.block_impl, got.kernel_impl) == ("cuda", "cuda")
    for f in ("arch", "shape", "seq_len", "global_batch", "n_devices",
              "kind", "data", "scheme", "c", "r", "sp_size", "placement",
              "seq_scheme", "block_skip", "remat", "microbatches",
              "comm_chunks", "grad_compression"):
        assert getattr(got, f) == getattr(plan_j, f), f
    assert got.run_config().grad_compression == "int8"
    mesh = got.build_mesh()
    assert (mesh.c, mesh.r, mesh.data, mesh.placement) == \
        (2, 1, 2, "ring_inner")


@pytest.mark.parametrize("field,value,item", [
    ("pod", 2, "§A item 1"), ("mesh_kind", "production", "§A item 1"),
    ("unroll_scans", True, None)])
def test_plan_file_unported_values_raise(field, value, item, tmp_path):
    """A JAX plan of several cards loads (the dry run traces it) and its
    runnable paths raise naming §A item 1; ``unroll_scans`` loads and
    runs (it changes nothing in the port)."""
    _, d = _jax_plan_dict()
    d[field] = value
    if field == "pod":
        d["n_devices"] = 16
    path = tmp_path / "PLAN_x.json"
    path.write_text(json.dumps({"plan": d}))
    plan = ExecutionPlan.load(path)
    assert getattr(plan, field) == value
    assert plan.to_dict()[field] == value
    if item is None:
        assert plan.build_mesh().size == 8
        return
    model = Model(registry.get_smoke(ARCH),
                  lambda s: torch.empty(s.shape, device="meta"))
    for build in (plan.check_runnable, plan.build_mesh,
                  lambda: plan.build_train_step(model, None)):
        with pytest.raises(NotImplementedError, match=f"{field}=.*{item}"):
            build()


@pytest.mark.parametrize("face", ["replicas", "roles"])
def test_plan_file_gateway_face_loads(face, tmp_path):
    """A JAX serve plan of 2 replicas, and each of a JAX prefill/decode
    pair, read into the port's plan with their gateway fields; the JAX
    validation holds in both packages."""
    cfg_j = jax_registry.get_smoke(ARCH)
    kw = dict(arch=ARCH, n_devices=2, decode_batch=2, page_size=4,
              max_len=64, mesh_kind="local", prefix_cache=True)
    if face == "replicas":
        plans_j = [jax_make_serve_plan(cfg_j, replicas=2, **kw)]
    else:
        plans_j = jax_make_role_plans(cfg_j, roles=["prefill", "decode"],
                                      **kw)
    for i, plan_j in enumerate(plans_j):
        got = ExecutionPlan.load(plan_j.save(tmp_path / f"PLAN_{i}.json"))
        for f in ("replicas", "role", "prefix_cache", "n_devices",
                  "decode_batch", "page_size", "seq_len"):
            assert getattr(got, f) == getattr(plan_j, f), f
        assert ExecutionPlan.from_dict(got.to_dict()) == got
    cfg = registry.get_smoke(ARCH)
    for bad, match in ((dict(replicas=0), "replicas"),
                       (dict(role="router"), "role")):
        with pytest.raises(ValueError, match=match):
            make_serve_plan(cfg, **bad)
        with pytest.raises(ValueError, match=match):
            jax_make_serve_plan(cfg_j, n_devices=1, mesh_kind="local", **bad)


def test_plan_file_host_tier_bytes_loads(tmp_path):
    """The JAX serve plan's host tier reads into the port's plan, with the
    JAX validation: >= 0, and only with the prefix cache."""
    cfg_j = jax_registry.get_smoke(ARCH)
    plan_j = jax_make_serve_plan(
        cfg_j, arch=ARCH, n_devices=1, decode_batch=2, page_size=4,
        max_len=64, mesh_kind="local", prefix_cache=True,
        host_tier_bytes=1 << 20)
    got = ExecutionPlan.load(plan_j.save(tmp_path / "PLAN_tier.json"))
    assert (got.host_tier_bytes, got.prefix_cache) == (1 << 20, True)
    cfg = registry.get_smoke(ARCH)
    assert make_serve_plan(cfg, prefix_cache=True, host_tier_bytes=4096
                           ).host_tier_bytes == 4096
    for kw in (dict(prefix_cache=True, host_tier_bytes=-1),
               dict(host_tier_bytes=4096)):
        with pytest.raises(ValueError, match="host_tier_bytes"):
            make_serve_plan(cfg, **kw)
        with pytest.raises(ValueError, match="host_tier_bytes"):
            jax_make_serve_plan(cfg_j, n_devices=1, mesh_kind="local", **kw)


def test_plan_roundtrip_and_path(tmp_path):
    cfg = registry.get_smoke(ARCH)
    plan = make_plan(cfg, tbase.ShapeConfig("smoke", 64, 4, "train"),
                     arch=ARCH, n_devices=8, data=2, c=2,
                     grad_compression="int8")
    path = plan.save(plan_path(tmp_path, ARCH, "smoke"))
    assert path.name == f"PLAN_{ARCH}_smoke.json"
    assert ExecutionPlan.load(path) == plan
    rec = json.loads(path.read_text())["plan"]
    assert (rec["r"], rec["sp_size"]) == (1, 4)
    assert ExecutionPlan.from_dict(rec) == plan
    serve = make_serve_plan(cfg, arch=ARCH, prefix_cache=True)
    assert ExecutionPlan.load(serve.save(tmp_path / "s.json")) == serve
    with pytest.raises(ValueError, match="grad_compression"):
        dataclasses.replace(plan, grad_compression="fp8")


# ---------------------------------------------------------------------------
# autotune and the launcher
# ---------------------------------------------------------------------------

def test_autotune_record_matches_jax(tmp_path, monkeypatch):
    """The smoke model at P = 4, top_k = 1: the analytical best and the
    anchor (the worst) are measured on the CPU. JAX's search runs with
    its timing and mesh stubbed (this process has one JAX device): only
    its record is compared."""
    cfg_j = jax_registry.get_smoke(ARCH)
    shape_j = JaxShapeConfig("smoke", 64, 2, "train")
    shape = tbase.ShapeConfig("smoke", 64, 2, "train")
    cl, cl_j = _clusters(4)
    monkeypatch.setattr(jax_autotune, "measure_plan",
                        lambda model, plan, **kw: float(plan.c))
    monkeypatch.setattr(JaxPlan, "build_mesh", lambda self: None)
    want = jax_autotune.autotune(cfg_j, shape_j, arch=ARCH, n_devices=4,
                                 top_k=1, steps=1, cluster=cl_j,
                                 out_dir=tmp_path / "jax")
    got = autotune.autotune(registry.get_smoke(ARCH), shape, arch=ARCH,
                            n_devices=4, top_k=1, steps=1, warmup=1,
                            cluster=cl, out_dir=tmp_path / "port",
                            device="cpu")
    rec = json.loads(got["path"].read_text())
    rec_j = json.loads(want["path"].read_text())
    assert got["path"] == plan_path(tmp_path / "port", ARCH, "smoke")
    # both records hold the overlap fraction the search was given (the
    # model's 1.0 here)
    assert sorted(rec) == sorted(rec_j)
    assert rec["overlap_frac"] == rec_j["overlap_frac"] == 1.0
    _same(rec["analytical"], rec_j["analytical"], "analytical")
    assert sorted(m["arrangement"] for m in rec["measured"]) == \
        sorted(m["arrangement"] for m in rec_j["measured"])
    assert len(rec["measured"]) == 2
    for k in ("n_devices", "data", "steps_timed"):
        assert rec[k] == rec_j[k], k
    times = [m["measured_s"] for m in rec["measured"]]
    assert times == sorted(times) and all(t > 0 for t in times)
    assert all(m["comm_chunks"] == 1 for m in rec["measured"])
    winner = ExecutionPlan.from_dict(rec["plan"])
    assert winner == got["plan"]
    # the file's plan is the arrangement its own record timed fastest
    fastest = min(rec["measured"], key=lambda m: m["measured_s"])
    assert fastest["arrangement"] == cost.Arrangement(
        winner.scheme, winner.c, winner.r, winner.placement).key


def test_launch_train_autotune_then_plan(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import train

    monkeypatch.setattr(autotune, "RESULTS", tmp_path)
    base = ["--smoke", "--device", "cpu"]
    out = train.main(base + ["--arch", ARCH, "--devices", "4", "--autotune",
                             "--steps", "2", "--batch", "2"])
    assert out["step"] == 2 and np.isfinite(out["loss"])
    path = plan_path(tmp_path, ARCH, "smoke")
    rec = json.loads(path.read_text())
    assert len(rec["measured"]) == 3          # every arrangement at P = 4
    out = train.main(base + ["--plan", str(path), "--steps", "1"])
    assert out["step"] == 1 and np.isfinite(out["loss"])
    text = capsys.readouterr().out
    assert f"[train] loaded plan {path}" in text
    winner = ExecutionPlan.load(path)
    assert (f"scheme={winner.scheme} C={winner.c} R={winner.r} data=1 "
            f"placement={winner.placement}") in text
    # with --c left open at P = 1 the ranking picks the ring (C = 1)
    out = train.main(base + ["--arch", ARCH, "--steps", "1"])
    assert "scheme=ring C=1 R=1" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# plan/cost.py: the serving half (every field) and the config pieces the
# dry run reads
# ---------------------------------------------------------------------------

SERVE_ARCHS = ("h2o-danube-1.8b", "phi3.5-moe-42b-a6.6b",
               "jamba-1.5-large-398b", "seamless-m4t-large-v2")


@pytest.mark.parametrize("name", SERVE_ARCHS)
def test_serving_cost_fields_match_jax(name, monkeypatch):
    """Dense, MoE, hybrid and encoder-decoder, under an equal explicit
    ``ClusterModel`` and the JAX table's HBM and host-link rates:
    ``prefill_step_cost``, ``chunked_prefill_cost``, ``decode_step_cost``,
    ``rank_decode_kernels`` (same order, 'cuda' for 'pallas'),
    ``prefix_cache_value`` and ``spill_threshold_tokens`` over cached
    lengths, chunks and page sizes, every field equal."""
    monkeypatch.setattr(hw, "HBM_BW", jax_hw.HBM_BW)
    monkeypatch.setattr(hw, "HOST_LINK_BW", jax_hw.HOST_LINK_BW)
    cfg_j = CONFIGS[name]
    cfg = _port_cfg(cfg_j)
    names = {"ref": "ref", "cuda": "pallas"}
    for sp in (1, 4, 16):
        cl, cl_j = _clusters(sp)
        for ps in (8, 16):
            for plen, cached in ((64, 0), (1000, 256), (32768, 4096),
                                 (512, 512)):
                kw = dict(prompt_len=plen, cached_len=cached, sp=sp,
                          page_size=ps)
                _same(cost.prefill_step_cost(cfg, cluster=cl, **kw),
                      jax_cost.prefill_step_cost(cfg_j, cluster=cl_j, **kw),
                      f"{name} prefill {kw}")
                for chunk in (0, 64, 500, 4096):
                    _same(cost.chunked_prefill_cost(cfg, chunk=chunk,
                                                    cluster=cl, **kw),
                          jax_cost.chunked_prefill_cost(
                              cfg_j, chunk=chunk, cluster=cl_j, **kw),
                          f"{name} chunked {chunk} {kw}")
            for batch, cache_len in ((1, 1), (8, 1000), (16, 32768)):
                kw = dict(batch=batch, cache_len=cache_len, sp=sp,
                          page_size=ps)
                for kernel in ("ref", "cuda"):
                    _same(cost.decode_step_cost(cfg, kernel=kernel,
                                                cluster=cl, **kw),
                          jax_cost.decode_step_cost(
                              cfg_j, kernel=names[kernel], cluster=cl_j,
                              **kw), f"{name} decode {kernel} {kw}")
                got = cost.rank_decode_kernels(cfg, cluster=cl, **kw)
                want = jax_cost.rank_decode_kernels(cfg_j, cluster=cl_j,
                                                    **kw)
                assert [names[e["kernel"]] for e in got] == \
                    [e["kernel"] for e in want]
                for g, w in zip(got, want):
                    _same({k: v for k, v in g.items() if k != "kernel"},
                          {k: v for k, v in w.items() if k != "kernel"},
                          f"{name} ranked {kw}")
            for plen, shared, pages in ((128, 96, 64), (4096, 1024, 4096),
                                        (128, 96, 4)):
                kw = dict(prompt_len=plen, shared_len=shared, requests=8,
                          sp=sp, page_size=ps, pages_per_shard=pages,
                          max_len=32)
                _same(cost.prefix_cache_value(cfg, cluster=cl, **kw),
                      jax_cost.prefix_cache_value(cfg_j, cluster=cl_j, **kw),
                      f"{name} value {kw}")
            for bw in (None, 1e9):
                kw = dict(sp=sp, page_size=ps, link_bw=bw,
                          max_tokens=1 << 16)
                assert cost.spill_threshold_tokens(cfg, cluster=cl, **kw) \
                    == jax_cost.spill_threshold_tokens(cfg_j, cluster=cl_j,
                                                       **kw), (name, kw)
    with pytest.raises(ValueError, match="cached_len"):
        cost.chunked_prefill_cost(cfg, prompt_len=8, cached_len=9)


def test_flops_params_and_cells_match_jax():
    """``model_flops_per_token`` and ``total_params`` on every JAX arch and
    the paper's models; the registry's ``ASSIGNED_ARCHS``, ``SHAPES``,
    ``shape_supported`` and ``cells`` against JAX's."""
    for name, cfg_j in CONFIGS.items():
        cfg = _port_cfg(cfg_j)
        assert tbase.model_flops_per_token(cfg) == \
            jax_base.model_flops_per_token(cfg_j), name
        assert tbase.total_params(cfg) == jax_base.total_params(cfg_j), name
    assert registry.ASSIGNED_ARCHS == jax_registry.ASSIGNED_ARCHS
    assert sorted(registry.PORTED_ARCHS) == sorted(registry.ASSIGNED_ARCHS)
    assert {k: dataclasses.asdict(v) for k, v in registry.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}
    assert registry.ShapeConfig is tbase.ShapeConfig
    assert registry.cells() == jax_registry.cells()
    ok, why = registry.shape_supported(registry.get(ARCH),
                                       registry.SHAPES["long_500k"])
    assert (ok, why) == jax_registry.shape_supported(
        jax_registry.get(ARCH), JAX_SHAPES["long_500k"])
    assert ok and not why     # h2o has a sliding window


@pytest.mark.parametrize("kw", [
    dict(n_devices=8, data=2, c=2, kind="train"),
    dict(n_devices=256, data=16, c=2, kind="decode", mesh_kind="production"),
    dict(n_devices=512, data=16, c=2, kind="prefill", pod=2,
         mesh_kind="production"),
    dict(n_devices=8, data=2, c=2, kind="train", unroll_scans=True,
         pipeline_scan=False)])
def test_plan_dict_equals_jax_key_for_key(kw, monkeypatch):
    """``make_plan`` with the JAX plan's mesh face (``pod``,
    ``mesh_kind``; ``unroll_scans`` and ``pipeline_scan`` set on the plan
    with ``dataclasses.replace``): ``to_dict`` equal to JAX's key for key,
    'cuda' read as 'pallas'; ``from_dict`` of the JAX dict gives the
    port's plan back. A production training plan with unset microbatches
    takes ``choose_microbatches``'s pick, JAX's under JAX's memory size."""
    kind = kw.pop("kind")
    face = {k: kw.pop(k) for k in ("unroll_scans", "pipeline_scan")
            if k in kw}
    shape = _shapes({"train": "train_4k", "prefill": "prefill_32k",
                     "decode": "decode_32k"}[kind])
    cfg_j = jax_registry.get(ARCH)
    cfg = _port_cfg(cfg_j)
    cl, cl_j = _clusters(kw["n_devices"] // (kw["data"] * kw.get("pod", 1)))
    want = jax_make_plan(cfg_j, shape[1], arch=ARCH, cluster=cl_j,
                         block_impl="pallas", kernel_impl="pallas",
                         microbatches=1, **face, **kw)
    got = dataclasses.replace(make_plan(cfg, shape[0], arch=ARCH, cluster=cl,
                                        microbatches=1, **kw), **face)
    d = {k: ("pallas" if v == "cuda" else v) for k, v in got.to_dict().items()}
    assert d == want.to_dict()
    assert ExecutionPlan.from_dict(want.to_dict()) == got
    if kw.get("mesh_kind") == "production":
        monkeypatch.setattr(hw, "HBM_BYTES", jax_hw.HBM_BYTES)
        train = _shapes("train_4k")
        want = jax_make_plan(cfg_j, train[1], arch=ARCH, cluster=cl_j,
                             block_impl="pallas", kernel_impl="pallas", **kw)
        got = make_plan(cfg, train[0], arch=ARCH, cluster=cl, **kw)
        assert got.microbatches == want.microbatches
        d = {k: ("pallas" if v == "cuda" else v)
             for k, v in got.to_dict().items()}
        assert d == want.to_dict()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_microbatch_costs_match_jax(name):
    """``activation_bytes_per_microbatch`` and ``choose_microbatches``
    against JAX's on the 13 configs, at train_4k over data degrees, SP
    degrees, C, ``remat`` and an explicit equal memory budget."""
    cfg_j = CONFIGS[name]
    cfg = _port_cfg(cfg_j)
    shape, shape_j = _shapes("train_4k")
    for dp, sp, c in ((1, 1, 1), (16, 16, 2), (4, 64, 4), (256, 1, 1)):
        for remat in ("none", "attn_out", "full"):
            for m in (1, 2, 4):
                assert cost.activation_bytes_per_microbatch(
                    cfg, shape, dp=dp, sp=sp, c=c, microbatches=m,
                    remat=remat) == jax_cost.activation_bytes_per_microbatch(
                        cfg_j, shape_j, dp=dp, sp=sp, c=c, microbatches=m,
                        remat=remat)
            for budget in (2**28, 2**32, 0.4 * jax_hw.HBM_BYTES,
                           0.4 * hw.HBM_BYTES):
                assert cost.choose_microbatches(
                    cfg, shape, dp=dp, sp=sp, c=c, remat=remat,
                    hbm_budget=budget) == jax_cost.choose_microbatches(
                        cfg_j, shape_j, dp=dp, sp=sp, c=c, remat=remat,
                        hbm_budget=budget)
    decode = _shapes("decode_32k")
    assert cost.choose_microbatches(cfg, decode[0], dp=1, sp=1) == 1
