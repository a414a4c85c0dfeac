"""repro_torch's process-separated serving front end (``frontend``)
against the JAX package's.

* Host-only units: the wire format and the packed step result, the
  engine's typed rejections, priority classes, SLO-priced admission, the
  cross-process Prometheus merge (its text equal to the JAX merge's on the
  same scrapes), and the orchestrator's policy on a scripted fake replica
  (class budgets, liveness and failover, drain).
* One smoke engine behind ``LocalReplica`` on the CPU: the orchestrator's
  streams equal the engine's; over ``LocalReplica(model=from_jax_params)``
  they equal the JAX orchestrator's over its ``LocalReplica`` on the same
  seed's weights (greedy: the port's sampling noise is not JAX's);
  preemption leaves greedy and sampled streams unchanged; the HTTP/SSE
  server end to end on an ephemeral port (400, 429 with Retry-After,
  /metrics, /plan, /healthz).
* Two spawned worker processes (``device='cpu'``): streams equal the
  in-process run's, each worker's weights equal by digest, the merged
  /metrics carries both workers, and after one worker is killed
  mid-decode every stream still equals the in-process run and
  ``chip_smoke.replay`` of the run over two ``LocalReplica``s.
* ``launch.serve --http --workers 0`` in a subprocess: a client request,
  then SIGTERM drains and exits 0.
"""

import dataclasses
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

from repro import obs as jax_obs
from repro.configs import registry as jax_registry
from repro.engine import EngineConfig as JaxEngineConfig
from repro.frontend import protocol as jax_protocol
from repro.frontend.orchestrator import Orchestrator as JaxOrchestrator
from repro.frontend.worker import LocalReplica as JaxLocalReplica
from repro.models.factory import build_model as jax_build_model
from repro.plan import make_serve_plan as jax_make_serve_plan
from repro_torch import obs
from repro_torch.configs import registry
from repro_torch.engine import EngineConfig, Rejection, Request, Scheduler
from repro_torch.frontend import protocol
from repro_torch.frontend.orchestrator import Orchestrator
from repro_torch.frontend.protocol import ReplicaDead, pack_step
from repro_torch.frontend.slo import (PriorityClass, SLOAdmission,
                                      default_classes, parse_classes)
from repro_torch.models.factory import from_jax_params
from repro_torch.plan import make_serve_plan

ARCH = "h2o-danube-1.8b"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import replay  # noqa: E402  (the chip script's replay)


# ---------------------------------------------------------------------------
# protocol: wire round trips and the packed step result
# ---------------------------------------------------------------------------

def test_request_wire_roundtrip():
    req = Request(uid=protocol.uid_for(7), tokens=[1, 2, 3],
                  max_new_tokens=4, temperature=0.8, top_k=16, top_p=0.9,
                  seed=3, priority="batch")
    wire = protocol.request_to_wire(req)
    assert protocol.request_from_wire(wire) == req
    assert protocol.rid_for(req.uid) == 7
    # the JAX wire dict of the same request carries the same fields
    jreq = jax_protocol.request_from_wire(wire)
    assert jax_protocol.request_to_wire(jreq) == wire


def test_rejection_wire_roundtrip():
    rej = Rejection("slo_ttft_unattainable", "priced out",
                    retry_after_steps=12)
    back = protocol.rejection_from_wire(protocol.rejection_to_wire(rej))
    assert back == rej and back.retryable
    assert not Rejection("empty_prompt", "no tokens").retryable


def test_pack_step_is_one_host_array():
    res = pack_step([(3, 101), (9, 102)], [9], free_slots=1, queued=2,
                    active=1, outstanding_tokens=40)
    assert isinstance(res.tokens, np.ndarray)
    assert res.tokens.dtype == np.int32 and res.tokens.shape == (2, 2)
    assert res.emitted == [(3, 101), (9, 102)]
    assert res.finished == [9]
    empty = pack_step([], [], free_slots=0, queued=0, active=0,
                      outstanding_tokens=0)
    assert empty.tokens.shape == (0, 2) and empty.emitted == []
    want = jax_protocol.pack_step([(3, 101), (9, 102)], [9], free_slots=1,
                                  queued=2, active=1, outstanding_tokens=40)
    assert dataclasses.asdict(res).keys() == dataclasses.asdict(want).keys()
    np.testing.assert_array_equal(res.tokens, want.tokens)


def test_worker_spec_fields():
    plan = make_serve_plan(registry.get_smoke(ARCH), arch=ARCH,
                           decode_batch=2, page_size=4, max_len=64)
    spec = protocol.make_worker_spec(plan=plan, eng=EngineConfig(),
                                     init_seed=3, device="cpu")
    assert spec["device"] == "cpu" and spec["smoke"] is True
    assert spec["init_seed"] == 3 and spec["n_devices"] == 1
    assert json.loads(json.dumps(spec)) == spec     # /plan serves it
    assert protocol.make_worker_spec(plan=plan)["device"] is None


# ---------------------------------------------------------------------------
# engine-side typed rejections (scheduler.validate, one reason each)
# ---------------------------------------------------------------------------

def _sched(**kw):
    base = dict(max_slots=2, page_size=4, sp=1, pages_per_shard=4,
                max_len=32)
    base.update(kw)
    return Scheduler(**base)


@pytest.mark.parametrize("req,reason", [
    (Request("a", [], 4), "empty_prompt"),
    (Request("b", [1, 2], 0), "bad_budget"),
    (Request("c", [1] * 30, 10), "too_long"),
    (Request("d", [1] * 20, 11), "pool_too_small"),
])
def test_engine_rejection_reasons(req, reason):
    rej = _sched().validate(req)
    assert rej is not None and rej.reason == reason
    assert rej.retry_after_steps is None    # all permanent
    with pytest.raises(ValueError):
        _sched().enqueue(req)


def test_valid_request_passes_validate():
    assert _sched().validate(Request("ok", [1, 2, 3], 4)) is None


# ---------------------------------------------------------------------------
# priority classes and SLO admission (analytical, no device)
# ---------------------------------------------------------------------------

def test_parse_classes():
    classes = parse_classes("interactive,batch,scavenger",
                            slo_ttft_ms=250.0, budget_tokens=1000)
    assert [c.rank for c in classes.values()] == [0, 1, 2]
    assert classes["interactive"].slo_ttft_ms == 250.0
    assert classes["interactive"].budget_tokens == 1000
    assert not classes["interactive"].preemptible
    assert classes["batch"].preemptible and classes["scavenger"].preemptible
    assert classes["batch"].slo_ttft_ms == 0.0
    with pytest.raises(ValueError):
        parse_classes("  ,  ")
    assert set(default_classes()) == {"interactive", "batch"}


def test_slo_admission_prices_queue_depth():
    cfg = registry.get_smoke(ARCH)
    slo = SLOAdmission(cfg, sp=1, page_size=4, decode_batch=4)
    d = slo.price(prompt_len=16, queued_tokens=0)
    assert d["ttft_s"] == pytest.approx(d["prefill_s"])
    d2 = slo.price(prompt_len=16, queued_tokens=4000)
    assert d2["ttft_s"] > d["ttft_s"]
    assert slo.check(prompt_len=16, slo_ttft_ms=0.0,
                     queued_tokens=10**9) is None
    rej = slo.check(prompt_len=16, slo_ttft_ms=1e-6, queued_tokens=10**6)
    assert rej is not None and rej.reason == "slo_ttft_unattainable"
    assert rej.retryable and rej.retry_after_steps >= 1
    assert slo.check(prompt_len=16, slo_ttft_ms=1e9, queued_tokens=0) is None
    # calibration scales every seconds field; the B4 row prices fewer bytes
    cal = SLOAdmission(cfg, sp=1, page_size=4, decode_batch=4,
                       kernel="cuda", calibration=1e3)
    d3 = cal.price(prompt_len=16, queued_tokens=4000)
    assert d3["prefill_s"] == pytest.approx(1e3 * d["prefill_s"])
    assert d3["decode_step_s"] < 1e3 * d2["decode_step_s"]


# ---------------------------------------------------------------------------
# the cross-process Prometheus merge
# ---------------------------------------------------------------------------

def _scrapes(o):
    w = o.Registry()
    w.counter("engine_steps_total", "steps").inc(5)
    w.gauge("engine_peak_pages", "pages").set(3, replica="1")
    h = w.histogram("engine_ttft_seconds", "ttft")
    for v in (0.002, 0.03, 0.4, 2.0, 100.0):
        h.observe(v)
    h.observe(0.05, cls="batch")
    return w, w.render_prometheus()


def test_prometheus_merge_roundtrip():
    w, text = _scrapes(obs)
    merged = obs.Registry()
    obs.merge_prometheus_text(merged, text, worker="0")
    obs.merge_prometheus_text(merged, text, worker="1")
    c = merged.get("engine_steps_total")
    assert c.value(worker="0") == 5 and c.value(worker="1") == 5
    hm = merged.get("engine_ttft_seconds")
    assert hm.count() == 12 and hm.count(worker="0") == 6
    assert hm.count(worker="1", cls="batch") == 1
    h = w.get("engine_ttft_seconds")
    assert hm.quantile(0.5) == h.quantile(0.5)
    assert merged.get("engine_peak_pages").value(replica="1",
                                                 worker="1") == 3
    fams = obs.parse_prometheus_families(text)
    assert fams["engine_ttft_seconds"]["kind"] == "histogram"
    assert fams["engine_steps_total"]["help"] == "steps"


def test_prometheus_merge_equals_jax():
    """The same scrapes merged by both packages render the same text."""
    out = []
    for o in (obs, jax_obs):
        _, text = _scrapes(o)
        merged = o.Registry()
        o.merge_prometheus_text(merged, text)
        o.merge_prometheus_text(merged, text, worker="0")
        o.merge_prometheus_text(merged, text, worker="1")
        out.append((merged.render_prometheus(),
                    o.parse_prometheus_families(text)))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# the orchestrator's policy on a scripted fake replica
# ---------------------------------------------------------------------------

class FakeReplica:
    """Engine-API double: admits everything, emits one token per active
    rid per step, finishes each request after its budget."""

    def __init__(self, index):
        self.index = index
        self.alive = True
        self.last = None
        self.active = {}                    # rid -> remaining budget
        self._pending = False

    def add(self, rid, wire):
        self.active[rid] = int(wire["max_new_tokens"])
        return None

    def step_send(self):
        if not self.alive:
            raise ReplicaDead(self.index)
        self._pending = True

    def step_recv(self):
        assert self._pending
        self._pending = False
        if not self.alive:
            raise ReplicaDead(self.index)
        emitted, finished = [], []
        for rid in list(self.active):
            emitted.append((rid, 1000 + rid))
            self.active[rid] -= 1
            if self.active[rid] <= 0:
                finished.append(rid)
                del self.active[rid]
        self.last = pack_step(
            emitted, finished, free_slots=4 - len(self.active), queued=0,
            active=len(self.active),
            outstanding_tokens=sum(self.active.values()))
        return self.last

    def preempt(self, rid):
        return None

    def idle(self):
        return not self.active

    def flush(self):
        pass

    def metrics_text(self):
        return ""

    def trace_events(self):
        return [{"name": "w", "ph": "X", "pid": 1}]

    def shutdown(self):
        self.alive = False

    def kill(self):
        self.alive = False


def test_frontend_rejection_reasons():
    orch = Orchestrator([FakeReplica(0)], classes={
        "interactive": PriorityClass("interactive", 0, budget_tokens=10)})
    rej = orch.submit([1, 2], 4, cls="nope")
    assert isinstance(rej, Rejection) and rej.reason == "unknown_class"
    assert isinstance(orch.submit([1, 2], 8), int)
    rej = orch.submit([1, 2], 8)            # 8 + 8 > 10-token class budget
    assert isinstance(rej, Rejection)
    assert rej.reason == "class_budget_exhausted" and rej.retryable
    orch.draining = True
    rej = orch.submit([1, 2], 2)
    assert isinstance(rej, Rejection) and rej.reason == "draining"
    orch.draining = False
    orch.run()
    orch.replicas[0].kill()
    orch.step()                             # notices the dead replica
    rej = orch.submit([1, 2], 2)
    assert isinstance(rej, Rejection) and rej.reason == "no_live_replica"
    c = orch.registry.get("frontend_rejections_total")
    for reason in ("unknown_class", "class_budget_exhausted", "draining",
                   "no_live_replica"):
        assert c.value(reason=reason) == 1, reason
    # an SLO the priced TTFT cannot meet: a 429-shaped rejection
    slo_orch = Orchestrator(
        [FakeReplica(0)],
        classes={"interactive": PriorityClass("interactive", 0,
                                              slo_ttft_ms=1e-9)},
        slo=SLOAdmission(registry.get_smoke(ARCH), sp=1, page_size=4,
                         decode_batch=2))
    rej = slo_orch.submit([1] * 16, 4)
    assert rej.reason == "slo_ttft_unattainable" and rej.retryable
    assert slo_orch.router.routed == [0]    # the refused route is undone


def test_failover_readmits_on_survivor():
    orch = Orchestrator([FakeReplica(0), FakeReplica(1)])
    rids = [orch.submit([1, 2, 3], 5) for _ in range(4)]
    for _ in range(2):
        orch.step()
    dead = orch.streams[rids[0]].replica
    survivor = 1 - dead
    orch.replicas[dead].kill()
    out = orch.run()
    for rid in rids:
        assert orch.streams[rid].done and len(out[rid]) == 5, rid
    moved = [r for r in rids if orch.streams[r].replica == survivor
             and orch.streams[r].resumed > 0]
    assert orch.registry.get("frontend_failovers_total").value() == 2
    assert moved and orch.deaths == [(2, dead)]
    assert orch.registry.get("frontend_live_replicas").value() == 1


def test_ttft_includes_the_step_that_computes_the_token():
    """TTFT runs from submission to the reply of the step that carried the
    first token, so it holds that step's work (the JAX orchestrator stamps
    the time before it collects the replies)."""
    class SlowReplica(FakeReplica):
        def step_recv(self):
            time.sleep(0.03)
            return super().step_recv()

    orch = Orchestrator([SlowReplica(0)])
    orch.submit([1, 2], 2)
    orch.run()
    h = orch.registry.get("frontend_ttft_seconds")
    assert h.count() == 1 and h.value(cls="interactive") >= 0.03
    assert orch.ttft_quantile(0.5) >= 0.025     # the (0.025, 0.05] bucket


def test_shutdown_drains_and_joins():
    orch = Orchestrator([FakeReplica(0)])
    rid = orch.submit([1, 2], 3)
    streams = orch.shutdown(drain=True)
    assert orch.draining
    assert streams[rid] == [1000 + rid] * 3
    assert not orch.replicas[0].alive
    assert orch.tracer.events() == [{"name": "w", "ph": "X", "pid": 1}]
    rej = orch.submit([1, 2], 3)
    assert isinstance(rej, Rejection) and rej.reason == "draining"


# ---------------------------------------------------------------------------
# one smoke engine behind LocalReplica (CPU)
# ---------------------------------------------------------------------------

_CTX = {}


def _spec():
    if not _CTX:
        cfg = registry.get_smoke(ARCH)
        plan = make_serve_plan(cfg, arch=ARCH, decode_batch=2, page_size=4,
                               max_len=64, prefix_cache=True)
        eng = EngineConfig(max_slots=2, page_size=4, pages_per_shard=64,
                           max_len=64)
        _CTX.update(spec=protocol.make_worker_spec(plan=plan, eng=eng,
                                                   device="cpu"),
                    cfg=cfg, plan=plan, eng=eng)
    return _CTX["spec"]


def _local(i=0, **kw):
    from repro_torch.frontend.worker import LocalReplica

    return LocalReplica(i, _spec(), **kw)


def _mixed_requests(n=4, gen=6, sampled=True):
    reqs = []
    for i in range(n):
        prompt = [(3 * i + j) % 97 + 1 for j in range(10 + i)]
        hot = sampled and i % 2 == 1
        reqs.append(dict(prompt=prompt, max_new_tokens=gen,
                         temperature=0.8 if hot else 0.0,
                         top_k=16 if hot else 0, seed=5 + i))
    return reqs


def _submit_all(orch, reqs, **kw):
    rids = []
    for r in reqs:
        r = dict(r, **kw)
        rid = orch.submit(r.pop("prompt"), r.pop("max_new_tokens"), **r)
        assert isinstance(rid, int), rid
        rids.append(rid)
    return rids


def test_orchestrator_matches_engine_tokens():
    from repro_torch.engine import Engine
    from repro_torch.models.factory import build_model

    reqs = _mixed_requests()
    orch = Orchestrator([_local()])
    rids = _submit_all(orch, reqs)
    out = orch.run()
    engine = Engine(build_model(_CTX["cfg"], device="cpu"), _CTX["plan"],
                    _CTX["eng"])
    for i, r in enumerate(reqs):
        assert engine.add_request(Request(
            uid=f"q{i}", tokens=r["prompt"],
            max_new_tokens=r["max_new_tokens"],
            temperature=r["temperature"], top_k=r["top_k"],
            seed=r["seed"])) is None
    ref = engine.run()
    for i, rid in enumerate(rids):
        assert out[rid] == ref[f"q{i}"], i
    rej = orch.submit([], 4)
    assert isinstance(rej, Rejection) and rej.reason == "empty_prompt"


def test_orchestrator_equals_jax():
    """The port's orchestrator over ``LocalReplica(model=
    from_jax_params(...))`` against the JAX orchestrator over its
    ``LocalReplica(spec)``, whose weights are the same seed's."""
    cfg_j = jax_registry.get_smoke(ARCH)
    plan_j = jax_make_serve_plan(cfg_j, arch=ARCH, n_devices=1,
                                 decode_batch=2, page_size=4, max_len=64,
                                 mesh_kind="local", prefix_cache=True)
    spec_j = jax_protocol.make_worker_spec(
        plan=plan_j, eng=JaxEngineConfig(max_slots=2, page_size=4,
                                         pages_per_shard=64, max_len=64))
    params = jax_build_model(cfg_j).init(jax.random.PRNGKey(0))
    model = from_jax_params(jax.tree.map(np.asarray, params),
                            registry.get_smoke(ARCH), "cpu")
    reqs = _mixed_requests(n=5, sampled=False)
    streams = []
    for orch in (Orchestrator([_local(0, model=model), _local(1, model=model)]),
                 JaxOrchestrator([JaxLocalReplica(0, spec_j),
                                  JaxLocalReplica(1, spec_j)])):
        rids = _submit_all(orch, reqs[:3])
        orch.step()
        rids += _submit_all(orch, reqs[3:])
        out = orch.run()
        streams.append(([out[r] for r in rids],
                        [orch.streams[r].replica for r in rids]))
    assert streams[0] == streams[1]
    assert set(streams[0][1]) == {0, 1}


def test_preemption_is_bit_identical():
    """Interactive arrivals preempt a slot-pinning batch stream; every
    stream, the preempted-and-resumed ones included, greedy and sampled,
    equals the preemption-off run."""
    classes = {"interactive": PriorityClass("interactive", 0),
               "batch": PriorityClass("batch", 1, preemptible=True)}

    def run(preempt):
        orch = Orchestrator([_local()], classes=classes, preempt=preempt)
        b1 = orch.submit(list(range(1, 11)), 12, cls="batch", seed=2)
        b2 = orch.submit(list(range(2, 12)), 12, cls="batch",
                         temperature=0.7, top_k=8, seed=3)
        for _ in range(6):
            orch.step()
        i1 = orch.submit(list(range(5, 13)), 4, cls="interactive", seed=9)
        out = orch.run()
        pre = sum(orch.streams[r].preemptions for r in (b1, b2))
        return [out[r] for r in (b1, b2, i1)], pre, orch

    on, n_on, orch = run(True)
    off, n_off, _ = run(False)
    assert n_on > 0 and n_off == 0
    assert on == off
    c = orch.registry.get("frontend_preemptions_total")
    assert c.value(cls="batch") == n_on


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _raw(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, json.dumps(body) if body else None,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read().decode()
    finally:
        conn.close()


def test_http_server_streams_and_rejects():
    """The asyncio HTTP/SSE server end to end on an ephemeral port:
    streamed tokens equal the orchestrator's; typed rejections map to 400
    and to 429 with Retry-After; /metrics, /plan and /healthz serve."""
    import asyncio
    import threading

    from repro_torch.frontend import client
    from repro_torch.frontend.server import FrontendServer, status_for

    assert status_for(Rejection("empty_prompt", "")) == 400
    assert status_for(Rejection("slo_ttft_unattainable", "",
                                retry_after_steps=3)) == 429
    assert status_for(Rejection("draining", "")) == 503
    assert status_for(Rejection("no_live_replica", "",
                                retry_after_steps=1)) == 503
    classes = {"interactive": PriorityClass("interactive", 0),
               "tight": PriorityClass("tight", 1, slo_ttft_ms=1e-9)}
    orch = Orchestrator([_local()], classes=classes,
                        slo=SLOAdmission(_CTX["cfg"], sp=1, page_size=4,
                                         decode_batch=2))
    srv = FrontendServer(orch, port=0, worker_spec=_spec(), workers=0)
    loop = asyncio.new_event_loop()

    def serve():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(srv.start())
        loop.run_forever()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    for _ in range(200):
        if srv.port:
            break
        time.sleep(0.05)
    assert srv.port, "server did not come up"
    try:
        res = client.generate("127.0.0.1", srv.port, [5, 3, 8, 1, 9, 2], 5,
                              seed=11)
        assert len(res["tokens"]) == 5 and res["n_streamed"] == 5
        assert res["tokens"] == orch.streams[res["rid"]].tokens
        many = client.generate_many("127.0.0.1", srv.port, [
            dict(prompt=r["prompt"], max_new_tokens=r["max_new_tokens"],
                 temperature=r["temperature"], top_k=r["top_k"],
                 seed=r["seed"]) for r in _mixed_requests()], concurrency=4)
        assert all(m["tokens"] == orch.streams[m["rid"]].tokens
                   for m in many)
        with pytest.raises(client.HTTPError) as ei:
            client.generate("127.0.0.1", srv.port, [], 4)
        assert ei.value.status == 400
        assert ei.value.body["error"] == "empty_prompt"
        status, headers, body = _raw(srv.port, "POST", "/generate",
                                     {"prompt": [1] * 8, "class": "tight",
                                      "max_new_tokens": 4})
        assert status == 429 and int(headers["Retry-After"]) >= 1
        assert json.loads(body)["error"] == "slo_ttft_unattainable"
        health = client.get_json("127.0.0.1", srv.port, "/healthz")
        assert health["ok"] and health["live_replicas"] == 1
        plan = client.get_json("127.0.0.1", srv.port, "/plan")
        assert plan["workers"] == 0 and plan["device"] == "cpu"
        metrics = client.get_text("127.0.0.1", srv.port, "/metrics")
        assert "frontend_ttft_seconds" in metrics
        assert 'worker="0"' in metrics
        assert _raw(srv.port, "GET", "/nope")[0] == 404
    finally:
        srv._stop.set()
        loop.call_soon_threadsafe(loop.stop)
        t.join(10)


# ---------------------------------------------------------------------------
# spawned workers: the engine API over real pipes, and a death mid-decode
# ---------------------------------------------------------------------------

def test_worker_processes_and_death_failover():
    """Two spawned workers on the CPU: streams equal the in-process run's,
    the workers' weights are equal bit for bit (digest), the merged
    /metrics carries both workers; one worker hard-killed mid-decode, every
    stream still equals the in-process run's and the replay of the
    recorded run over two LocalReplicas; the workers join on shutdown."""
    from repro_torch.frontend.worker import ProcReplica

    spec = _spec()
    reqs = _mixed_requests(n=6, gen=5)
    base = Orchestrator([_local()])
    want = [base.run()[r] for r in _submit_all(base, reqs)]
    local_digest = base.replicas[0].digest()

    orch = Orchestrator([ProcReplica(0, spec), ProcReplica(1, spec)])
    try:
        assert all(r.start_s > 0 for r in orch.replicas)
        assert [r.digest() for r in orch.replicas] == [local_digest] * 2
        rids = _submit_all(orch, reqs)
        assert {orch.streams[r].replica for r in rids} == {0, 1}
        out = orch.run()
        assert [out[r] for r in rids] == want
        merged = orch.metrics_text()
        assert 'worker="0"' in merged and 'worker="1"' in merged
        assert "engine_steps_total" in merged
        # round 2: kill one worker mid-decode
        rids2 = _submit_all(orch, reqs)
        for _ in range(2):
            orch.step()
        victim = next(i for i in (0, 1)
                      if any(orch.streams[r].replica == i
                             and not orch.streams[r].done for r in rids2))
        orch.replicas[victim].kill()
        out2 = orch.run()
        assert [out2[r] for r in rids2] == want
        failovers = orch.registry.get("frontend_failovers_total").value()
        assert failovers >= 1 and len(orch.live()) == 1
        assert [d[1] for d in orch.deaths] == [victim]
    finally:
        orch.shutdown(drain=False)
    assert all(not r.proc.is_alive() for r in orch.replicas)
    again = replay(orch, [_local(0), _local(1)])
    assert [again[r] for r in rids + rids2] == [out[r] for r in rids] \
        + [out2[r] for r in rids2]


def test_proc_replica_startup_failure_raises():
    """A worker whose build fails reports it: ReplicaDead, not a hang."""
    from repro_torch.frontend.worker import ProcReplica

    bad = dict(_spec(), plan=dict(_spec()["plan"], arch="no-such-arch"))
    with pytest.raises(ReplicaDead, match="no-such-arch"):
        ProcReplica(0, bad, start_timeout_s=120)


# ---------------------------------------------------------------------------
# launch.serve --http
# ---------------------------------------------------------------------------

def test_launch_serve_http_drains_on_sigterm():
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--http", "--workers", "0",
         "--port", str(port), "--max-slots", "2", "--page-size", "4",
         "--max-len", "64", "--slo-ttft-ms", "1e-9",
         "--priority-classes", "interactive,batch", "--preempt"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        from repro_torch.frontend import client

        for _ in range(600):
            try:
                if client.get_json("127.0.0.1", port, "/healthz")["ok"]:
                    break
            except OSError:
                time.sleep(0.1)
        res = client.generate("127.0.0.1", port, [3, 1, 4, 1, 5], 4,
                              cls="batch")
        assert len(res["tokens"]) == 4
        with pytest.raises(client.HTTPError) as ei:
            client.generate("127.0.0.1", port, [3, 1, 4, 1, 5], 4)
        assert ei.value.status == 429       # the interactive class's SLO
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-3000:]
    assert "[frontend] drained; workers joined" in stdout
    assert "--workers 0: one in-process replica" in stdout
