"""repro_torch's pipelined ring, its overlap report and the overlap-aware
planner against the JAX package.

* ``check_pipelined_bitexact`` (``repro.testing.dist_checks``) on the port:
  at (C, P) = (2, 8), bf16 inputs, the loss and every gradient are
  ``torch.equal`` across ``pipeline`` on and off and ``comm_chunks`` 1, 2
  and 4, with the same ledger bytes, also on the contiguous layout with a
  window of 16 and ``block_skip``. The pipelined ring in f32 is held
  against JAX's ``startrail_attention`` (pipelined, on an 8-device mesh in
  the JAX child below) within 2e-4, the StarTrail tests' tolerance.
* The issue log: pipelined, step s+1's transfer starts before step s's
  block call and is awaited after it, in the forward (K/V) and the
  backward (the q, do, delta, lse pack); unpipelined, every transfer starts
  after the block call.
* ``dist.comm``'s split-phase pair: values and ledger bytes of
  ``ppermute``, the identity shortcut, the refusal of an input that needs a
  gradient, ``TraceComm``'s permute deferred to ``wait``.
* ``obs.commlog.overlap_report`` at h2o-danube-1.8b's heads (32q/8kv of
  80), seq 64, (C, R) = (2, 2) and (1, 8), comm_chunks 1 and 2: the JAX
  report's keys, ``permutes_total`` and ``arrangement`` equal JAX's (the
  C = 1 identity placement counted, as XLA keeps it), the gauge's labels
  JAX's. The fractions differ, pinned with their two causes.
* ``cost.rank_arrangements`` (every arrangement, and a given list),
  ``cost.choose_comm_chunks`` (over a grid) and ``make_plan`` (comm_chunks
  unset) against JAX's at ``overlap_frac`` 0, 0.5 and 1, under equal
  explicit ``ClusterModel``s; ``autotune(comm_chunk_grid=(1, 2, 3),
  overlap_frac=0.5)`` gives JAX's candidates and records the fraction;
  a production mesh raises.
* ``launch.train --no-pipeline`` on a CPU ``ThreadMesh`` (the ring at
  P = 4) trains the same bits as the pipelined default.

The JAX references (eight compiled reports and one pipelined StarTrail
run) come from one child process with 8 forced host devices, started by
the first test that needs them.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax  # noqa: F401  (both frameworks share the test process)
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.plan import autotune as jax_autotune
from repro.plan import cost as jax_cost
from repro.plan.plan import ExecutionPlan as JaxPlan
from repro.plan.plan import make_plan as jax_make_plan
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import startrail as st
from repro_torch.dist.comm import SingleComm, ThreadMesh, TraceComm
from repro_torch.obs import Registry, commlog
from repro_torch.plan import autotune, cost, make_plan
from test_torch_plan import _clusters, _port_cfg, _same, _shapes

ARCH = "h2o-danube-1.8b"
TOL = 2e-4
# check_pipelined_bitexact's layout: (C, P) = (2, 8), its smoke sizes
C, R, SEQ, BATCH, HQ, HKV, D = 2, 2, 64, 2, 4, 2, 8
REPORT_SEQ = 64
REPORT_CASES = [(2, 1), (2, 2), (1, 1), (1, 2)]        # (C, comm_chunks)
FRACTIONS = (0.0, 0.5, 1.0)


def _inputs(dtype=np.float32):
    """q, k, v in the sequence's shard order, from a seed."""
    rng = np.random.default_rng(7)
    return [rng.normal(size=(BATCH, SEQ, h, D)).astype(dtype)
            for h in (HQ, HKV, HKV)]


def _report_plan(make, cfg, shape_cls, c, chunks, pipeline):
    return make(cfg, shape_cls("overlap", REPORT_SEQ, 1, "train"),
                arch=ARCH, n_devices=8, c=c,
                scheme="ring" if c == 1 else "startrail",
                comm_chunks=chunks, pipeline_scan=pipeline)


def jax_references():
    """The JAX side (run in the child with 8 forced host devices)."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core import startrail as jst
    from repro.obs import commlog as jax_commlog
    from repro.obs.registry import Registry as JaxRegistry
    from repro.testing.dist_checks import AXES, make_mesh

    cfg = jax_registry.get(ARCH)
    reports = {}
    for c, chunks in REPORT_CASES:
        for pipeline in (True, False):
            reg = JaxRegistry()
            plan = _report_plan(jax_make_plan, cfg, JaxShapeConfig, c,
                                chunks, pipeline)
            rep = jax_commlog.overlap_report(cfg, plan, batch=1,
                                             seq_len=REPORT_SEQ,
                                             registry=reg)
            rep["gauge_labels"] = [
                list(map(list, key)) for key in
                reg.get("attention_overlap_fraction")._series]
            reports[f"{c}-{chunks}-{pipeline}"] = rep

    scfg = jst.StarTrailConfig(seq_len=SEQ, axes=AXES, seq_scheme="zigzag",
                               causal=True, pipeline=True)
    spec = P(None, AXES, None, None)
    dist = jax.jit(jax.shard_map(
        lambda q, k, v: jst.startrail_attention(q, k, v, scfg),
        mesh=make_mesh(C, C * C * R), in_specs=(spec,) * 3, out_specs=spec,
        check_vma=False))

    def loss(q, k, v):
        return (dist(q, k, v).astype(jnp.float32) ** 2).sum()

    val, grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(x) for x in _inputs()))
    return {"reports": reports, "loss": float(val),
            "grads": [np.asarray(g).tolist() for g in grads]}


_JAX_CHILD = r"""
import json, sys
sys.path.insert(0, "tests")
from test_torch_overlap import jax_references
json.dump(jax_references(), open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = tmp_path_factory.mktemp("overlap") / "jax.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(root, "src"))
    proc = subprocess.Popen([sys.executable, "-c", _JAX_CHILD, str(path)],
                            cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    state = {}

    def load():
        if "want" not in state:
            _, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stderr[-4000:]
            state["want"] = json.loads(path.read_text())
        return state["want"]

    try:
        yield load
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


# ---------------------------------------------------------------------------
# the ring's two issue orders
# ---------------------------------------------------------------------------

def _run_ring(pipeline, comm_chunks, *, seq_scheme="zigzag", window=None,
              block_skip=False, dtype=torch.bfloat16):
    """Every rank's local loss sum(o**2), its gradients, ledger and issue
    log, from the inputs in shard order."""
    cfg = st.StarTrailConfig(seq_len=SEQ, seq_scheme=seq_scheme,
                             window=window, block_skip=block_skip,
                             comm_chunks=comm_chunks, pipeline=pipeline)
    full = [torch.from_numpy(x).to(dtype) for x in _inputs()]
    s_local = SEQ // (C * C * R)

    def rank_fn(comm):
        rank = ((comm.axis_index("sp_grp") * R + comm.axis_index("sp_ring"))
                * C + comm.axis_index("sp_team"))
        q, k, v = (x[:, rank * s_local:(rank + 1) * s_local].clone()
                   .requires_grad_() for x in full)
        loss = (st.startrail_attention(q, k, v, cfg, comm).float()
                ** 2).sum()
        loss.backward()
        return (loss.detach(), [x.grad for x in (q, k, v)],
                comm.ledger.snapshot(), comm.issue_log)

    return ThreadMesh(C, R).run(rank_fn, timeout=60)


_RUNS = {}


def _cached_run(*key, **kw):
    k = key + tuple(sorted(kw.items()))
    if k not in _RUNS:
        _RUNS[k] = _run_ring(*key, **kw)
    return _RUNS[k]


@pytest.mark.parametrize("case", [
    (True, 1), (True, 2), (True, 4), (False, 2), (False, 4), "window"])
def test_issue_orders_and_chunks_are_bitexact(case, jax_refs):
    """Against the unpipelined, unchunked ring; the windowed case
    pipelined at 2 chunks against unpipelined at 1, with skipping. (Asks
    for ``jax_refs`` only to start the JAX child early.)"""
    if case == "window":
        kw = dict(seq_scheme="contiguous", window=16, block_skip=True)
        base, run = _cached_run(False, 1, **kw), _cached_run(True, 2, **kw)
    else:
        base, run = _cached_run(False, 1), _cached_run(*case)
    for (l0, g0, led0, _), (l1, g1, led1, _) in zip(base, run):
        assert torch.equal(l0, l1)
        for name, a, b in zip("qkv", g0, g1):
            assert a.dtype == torch.bfloat16
            assert torch.equal(a, b), f"d{name}"
        assert led0 == led1
    assert all(led0["forward"]["collective-permute"] > 0
               and led0["backward"]["collective-permute"] > 0
               for _, _, led0, _ in base)


def test_pipelined_ring_matches_jax_startrail(jax_refs):
    want = jax_refs()
    run = _run_ring(True, 1, dtype=torch.float32)
    loss = sum(float(rank[0]) for rank in run)
    np.testing.assert_allclose(loss, want["loss"], rtol=TOL, atol=TOL)
    for i, name in enumerate("qkv"):
        got = torch.cat([rank[1][i] for rank in run], 1).numpy()
        np.testing.assert_allclose(got, np.asarray(want["grads"][i]),
                                   rtol=TOL, atol=TOL, err_msg=f"d{name}")


def _phase(log, phase):
    """The starts, waits and block calls of one pass, with their ids."""
    return [e[:-1] for e in log if e[-1] == phase and e[0] != "scope"]


def _windows(events):
    """Per block call (in order): the transfers open around it."""
    open_ids, out = set(), []
    for e in events:
        if e[0] == "start":
            open_ids.add(e[1])
        elif e[0] == "wait":
            open_ids.discard(e[1])
        else:
            out.append(set(open_ids))
    return out


@pytest.mark.parametrize("pipeline", [True, False])
def test_issue_log_order(pipeline):
    log = _cached_run(pipeline, 1)[0][3]
    fwd, bwd = _phase(log, "forward"), _phase(log, "backward")
    # forward: the placement (K, V: start, wait each), then R blocks with
    # one K/V transfer (2 permutes) between steps 0 and 1
    assert [e[0] for e in fwd[:4]] == ["start", "wait"] * 2
    ring = fwd[4:]
    if pipeline:
        assert [e[0] for e in ring] == ["start", "start", "block", "wait",
                                        "wait", "block"]
        assert [len(w) for w in _windows(ring)] == [2, 0]
    else:
        assert [e[0] for e in ring] == ["block", "start", "wait", "start",
                                        "wait", "block"]
        assert [len(w) for w in _windows(ring)] == [0, 0]
    # backward: step 0's block inside the pack's four transfers when
    # pipelined; dq leaves after each block; the inverse placement last
    windows = _windows(bwd)
    assert [len(w) for w in windows] == ([4, 0] if pipeline else [0, 0])
    blocks = [i for i, e in enumerate(bwd) if e[0] == "block"]
    after_first = bwd[blocks[0] + 1:blocks[1]]
    if pipeline:
        # dq's transfer, then the pack's waits
        assert [e[0] for e in after_first] == ["start", "wait"] + \
            ["wait"] * 4
    else:
        # dq's transfer, then the pack's, each synchronous
        assert [e[0] for e in after_first] == ["start", "wait"] * 5
    scopes = [e[1] for e in log if e[0] == "scope" and e[-1] == "forward"]
    assert scopes == (["ring_permute_issue", "ring_block_compute",
                       "ring_block_compute"] if pipeline else
                      ["ring_block_compute", "ring_permute_issue",
                       "ring_block_compute"])


# ---------------------------------------------------------------------------
# the split-phase pair
# ---------------------------------------------------------------------------

def test_ppermute_start_equals_ppermute():
    perm = [(0, 1), (1, 0)]

    def rank_fn(comm):
        x = torch.arange(6.0).reshape(2, 3) + 10 * comm.rank
        h = comm.ppermute_start(x[:, 1:], "sp_ring", perm)
        y = comm.ppermute(x[:, 1:], "sp_ring", perm)
        split = h.wait()
        led = comm.ledger.snapshot()
        same = comm.ppermute(x, "sp_grp", [(0, 0)])
        ident = comm.ppermute_start(x, "sp_grp", [(0, 0)]).wait()
        with pytest.raises(ValueError, match="carries no gradient"):
            comm.ppermute_start(x.clone().requires_grad_(), "sp_ring", perm)
        return split, y, led, same is x and ident is x, comm.issue_log

    for rank, (split, y, led, ident, log) in enumerate(
            ThreadMesh(1, 2).run(rank_fn, timeout=30)):
        want = torch.arange(6.0).reshape(2, 3)[:, 1:] + 10 * (1 - rank)
        assert torch.equal(split, want) and torch.equal(y, want)
        assert led["forward"]["collective-permute"] == 2 * 4 * 4
        assert ident
        assert [e[0] for e in log] == ["start", "start", "wait", "wait",
                                       "start", "wait", "start", "wait"]
    one = SingleComm()
    x = torch.ones(3)
    assert one.ppermute_start(x, "sp_ring", [(0, 0)]).wait() is x
    assert torch.equal(one.ppermute_start(x, "sp_ring", []).wait(),
                       torch.zeros(3))


def test_trace_comm_defers_the_permute_to_wait():
    comm = TraceComm(c=1, r=4)
    x = torch.empty((1, 8, 2, 4), device="meta")
    h = comm.ppermute_start(x, "sp_ring", [(i, (i + 1) % 4)
                                           for i in range(4)])
    assert comm.log == []
    y = h.wait()
    assert h.wait() is y and y.shape == x.shape and len(comm.log) == 1
    assert comm.log[0][:4] == ("ppermute", "collective-permute", 256, 4)
    comm.ppermute_start(x, "sp_grp", [(0, 0)]).wait()
    assert len(comm.log) == 2 and comm.issue_log is None


# ---------------------------------------------------------------------------
# the overlap report
# ---------------------------------------------------------------------------

_REPORTS = {}


def _port_report(c, chunks, pipeline):
    key = (c, chunks, pipeline)
    if key not in _REPORTS:
        cfg = registry.get(ARCH)
        plan = _report_plan(make_plan, cfg, ShapeConfig, c, chunks,
                            pipeline)
        reg = Registry()
        rep = commlog.overlap_report(cfg, plan, batch=1,
                                     seq_len=REPORT_SEQ, registry=reg,
                                     device="cpu")
        _REPORTS[key] = rep, reg
    return _REPORTS[key]


@pytest.mark.parametrize("c,chunks", REPORT_CASES)
def test_overlap_report_counts_permutes_as_jax(jax_refs, c, chunks):
    for pipeline in (True, False):
        want = jax_refs()["reports"][f"{c}-{chunks}-{pipeline}"]
        got, reg = _port_report(c, chunks, pipeline)
        assert set(want) - {"gauge_labels"} <= set(got)
        assert got["permutes_total"] == want["permutes_total"]
        assert got["arrangement"] == want["arrangement"]
        assert got["shape"] == want["shape"]
        assert got["ranks_agree"] and got["timed_overlap_fraction"] is None
        assert [list(map(list, k)) for k in reg.get(
            "attention_overlap_fraction")._series] == want["gauge_labels"]
    # JAX's compiled island: 4 and 6 at (2, 2), 16 and 30 at (1, 8)
    assert got["permutes_total"] == {(2, 1): 4, (2, 2): 6, (1, 1): 16,
                                     (1, 2): 30}[(c, chunks)]


@pytest.mark.parametrize("c,chunks", REPORT_CASES)
def test_overlap_fraction_is_the_ports_own_schedule(jax_refs, c, chunks):
    """Pinned difference. JAX: 0.75 at (2, 2) and 0.9375 at (1, 8) in
    both issue orders, because XLA's CPU scheduler hoists the permutes
    whatever order the scan issues them in, and a block is two dots (QK^T
    and PV), the last block's second dot the only one outside a window.
    The port: one fused kernel launch a block (B2), with no compiler
    between the loop and the card, so the issue order is the schedule:
    (R-1)/R of the forward's blocks inside a transfer's window pipelined,
    none unpipelined; the backward's blocks likewise."""
    r = 8 // (c * c)
    for pipeline, frac in ((True, (r - 1) / r), (False, 0.0)):
        want = jax_refs()["reports"][f"{c}-{chunks}-{pipeline}"]
        got, _ = _port_report(c, chunks, pipeline)
        assert want["overlap_fraction"] == (0.75 if c == 2 else 0.9375)
        assert want["dots_total"] == 2 * r
        assert (got["overlap_fraction"], got["dots_total"]) == (frac, r)
        assert got["backward"]["overlap_fraction"] == frac
        ring = (r - 1) * 2 * chunks          # the forward's K/V transfers
        assert got["permutes_with_overlap_window"] == (ring if pipeline
                                                       else 0)
        assert got["ring_scope_instructions"]["ring_block_compute"] == r


def test_timed_overlap_of_device_events():
    """Copies on a stream with no kernel, hidden where a kernel ran."""
    ev = [("flash_fwd", 7, 0, 100), ("flash_bwd", 7, 150, 300),
          ("Memcpy DtoD (Device -> Device)", 21, 50, 170),
          ("Memcpy DtoD (Device -> Device)", 22, 310, 330),
          ("Memcpy HtoD (Pageable -> Device)", 7, 100, 110),
          ("Memset (Device)", 7, 110, 120)]
    t = commlog.timed_overlap(ev)
    assert t["copies"] == 2
    assert t["copy_ms"] == pytest.approx(140e-6)
    assert t["copy_hidden_ms"] == pytest.approx(70e-6)
    assert t["timed_overlap_fraction"] == pytest.approx(0.5)
    assert t["kernel_ms"] == pytest.approx(250e-6)
    assert t["device_busy_ms"] == pytest.approx(320e-6)
    # a DtoD copy on a kernel's stream is no comm-stream copy, but the
    # device is busy during it (a synchronous permute's copy)
    assert commlog.timed_overlap(ev[:2] + [(ev[2][0], 7, 100, 150)])[
        "copies"] == 0
    sync = commlog.timed_overlap(ev + [(ev[2][0], 7, 300, 305)])
    assert sync["copies"] == 2
    assert sync["device_busy_ms"] == pytest.approx(325e-6)


# ---------------------------------------------------------------------------
# the overlap-aware plan and search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frac", FRACTIONS)
def test_overlap_frac_through_the_cost_model_and_make_plan(frac):
    cfg_j = jax_registry.get(ARCH)
    cfg = _port_cfg(cfg_j)
    shape, shape_j = _shapes("train_4k")
    for sp in (4, 8, 16):
        cl, cl_j = _clusters(sp)
        for chunks in (1, 2):
            _same(cost.rank_arrangements(cfg, shape, sp, batch=1,
                                         cluster=cl, overlap_frac=frac,
                                         comm_chunks=chunks),
                  jax_cost.rank_arrangements(cfg_j, shape_j, sp, batch=1,
                                             cluster=cl_j,
                                             overlap_frac=frac,
                                             comm_chunks=chunks),
                  f"rank P={sp}")
        arrs = jax_cost.enumerate_arrangements(cfg_j, sp)[::2]
        _same(cost.rank_arrangements(
            cfg, shape, sp, batch=1, cluster=cl, overlap_frac=frac,
            arrangements=[cost.Arrangement(a.scheme, a.c, a.r, a.placement)
                          for a in arrs]),
              jax_cost.rank_arrangements(cfg_j, shape_j, sp, batch=1,
                                         cluster=cl_j, overlap_frac=frac,
                                         arrangements=arrs),
              f"given P={sp}")
        for arr in jax_cost.enumerate_arrangements(cfg_j, sp):
            port_arr = cost.Arrangement(arr.scheme, arr.c, arr.r,
                                        arr.placement)
            for grid in ((1, 2, 4), (1, 3, 8, 16)):
                assert cost.choose_comm_chunks(
                    cfg, shape, sp, port_arr, batch=1, cluster=cl,
                    overlap_frac=frac, grid=grid) == \
                    jax_cost.choose_comm_chunks(
                        cfg_j, shape_j, sp, arr, batch=1, cluster=cl_j,
                        overlap_frac=frac, grid=grid)
        for c in (1, 2):
            if sp % (c * c):
                continue
            want = jax_make_plan(cfg_j, shape_j, arch=ARCH, n_devices=sp,
                                 c=c, cluster=cl_j, block_impl="pallas",
                                 kernel_impl="pallas", overlap_frac=frac)
            got = make_plan(cfg, shape, arch=ARCH, n_devices=sp, c=c,
                            cluster=cl, overlap_frac=frac)
            d = {k: ("pallas" if v == "cuda" else v)
                 for k, v in got.to_dict().items()}
            assert d == want.to_dict()
    plan = make_plan(cfg, shape, arch=ARCH, n_devices=8, c=2,
                     pipeline_scan=False)
    assert not plan.pipeline_scan and not plan.run_config().pipeline_scan


def test_autotune_chunk_grid_matches_jax(tmp_path, monkeypatch):
    """Smoke h2o at P = 4, top_k = 3, ``comm_chunk_grid=(1, 2, 3)`` at
    overlap 0.5: the measured (arrangement, comm_chunks) pairs are JAX's
    (Ulysses unchunked, 3 not dividing the team sequence skipped). Both
    searches run with their timing stubbed, JAX's with its mesh too."""
    cfg_j = jax_registry.get_smoke(ARCH)
    shape_j = JaxShapeConfig("smoke", 64, 2, "train")
    shape = ShapeConfig("smoke", 64, 2, "train")
    cl, cl_j = _clusters(4)
    monkeypatch.setattr(jax_autotune, "measure_plan",
                        lambda model, plan, **kw: float(plan.c))
    monkeypatch.setattr(JaxPlan, "build_mesh", lambda self: None)
    # the port's measured steps are tested in test_torch_plan.py
    monkeypatch.setattr(autotune, "measure_plan",
                        lambda model, plan, **kw: float(plan.c))
    kw = dict(arch=ARCH, n_devices=4, top_k=3, steps=1,
              overlap_frac=0.5, comm_chunk_grid=(1, 2, 3))
    want = jax_autotune.autotune(cfg_j, shape_j, cluster=cl_j,
                                 out_dir=tmp_path / "jax", **kw)
    got = autotune.autotune(registry.get_smoke(ARCH), shape, cluster=cl,
                            out_dir=tmp_path / "port", device="cpu",
                            warmup=1, **kw)
    rec = json.loads(got["path"].read_text())
    rec_j = json.loads(want["path"].read_text())
    assert sorted(rec) == sorted(rec_j)
    assert rec["overlap_frac"] == rec_j["overlap_frac"] == 0.5
    pairs = sorted((m["arrangement"], m["comm_chunks"])
                   for m in rec["measured"])
    assert pairs == sorted((m["arrangement"], m["comm_chunks"])
                           for m in rec_j["measured"])
    assert {n for _, n in pairs} == {1, 2}
    _same(rec["analytical"], rec_j["analytical"], "analytical")
    for e in got["measured"]:
        assert e["plan"].comm_chunks == e["comm_chunks"]
    with pytest.raises(NotImplementedError, match="mesh_kind"):
        autotune.autotune(registry.get_smoke(ARCH), shape, arch=ARCH,
                          n_devices=4, mesh_kind="production", device="cpu",
                          out_dir=tmp_path / "prod")


def test_launch_train_no_pipeline_trains_the_same_bits(tmp_path, capsys):
    from repro_torch.launch import train

    base = ["--arch", ARCH, "--smoke", "--device", "cpu", "--devices", "4",
            "--scheme", "ring", "--steps", "2", "--seq-len", "16",
            "--batch", "1"]
    lines = {}
    for name, flags in (("pipelined", []), ("unpipelined",
                                            ["--no-pipeline"])):
        path = tmp_path / f"{name}.jsonl"
        train.main(base + flags + ["--metrics", str(path)])
        lines[name] = [json.loads(x) for x in path.read_text().splitlines()]
    out = capsys.readouterr().out
    assert "pipeline=True" in out and "pipeline=False" in out
    for a, b in zip(lines["pipelined"], lines["unpipelined"]):
        for k in ("step", "loss", "grad_norm"):
            assert a[k] == b[k], k
    assert len(lines["pipelined"]) == 2


def test_plan_dict_carries_the_issue_order():
    cfg = registry.get_smoke(ARCH)
    plan = make_plan(cfg, ShapeConfig("smoke", 64, 4, "train"), arch=ARCH,
                     n_devices=8, c=2, pipeline_scan=False)
    again = type(plan).from_dict(json.loads(json.dumps(plan.to_dict())))
    assert again == plan and not again.pipeline_scan
    assert dataclasses.replace(plan, pipeline_scan=True).run_config() \
        .pipeline_scan
