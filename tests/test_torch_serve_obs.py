"""The serving half of repro_torch.obs vs the JAX package.

* ``EngineMetrics.latency_quantiles`` reads the registry's fixed-bucket
  histograms, as the JAX one does: the same TTFT and inter-token
  observations give the same quantiles and counts in both packages (the
  port took exact percentiles of raw lists before), and ``Histogram``'s
  ``quantile``/``bucket_counts``/``count`` agree, past the last bound too.
* Counters, gauges and labelled histograms render the same Prometheus text
  and JSON in both registries, and both ``parse_prometheus`` read it back
  to the same series.
* The same greedy workload (a request joining mid-run, the prefix cache on)
  through the JAX engine and the port's engine on the
  same weights: equal streams; the same metric names, kinds and label sets
  (the port adds ``engine_prefill_wall_seconds`` and
  ``engine_decode_wall_seconds``), the host KV tier's ten series among
  them; equal values of every deterministic
  field and equal histogram counts; the same sequence of (name, cat, ph)
  trace events. The compile counters are left out of the values: JAX
  counts jit traces, and the port has none.
* ``launch.serve --metrics-dump`` (text and JSON) and ``--trace-out`` on
  the CPU, with sampling flags.
"""

import json

import jax
import numpy as np
import pytest

from repro import engine as jax_engine
from repro import obs as jax_obs
from repro.configs import registry as jax_registry
from repro.engine.engine import EngineMetrics as JaxEngineMetrics
from repro.models.factory import build_model as jax_build_model
from repro.plan import make_serve_plan as jax_make_serve_plan
from repro_torch import engine as torch_engine
from repro_torch import obs
from repro_torch.engine.engine import EngineMetrics
from repro_torch.models.factory import from_jax_params
from repro_torch.plan import make_serve_plan

ARCH = "h2o-danube-1.8b"
ENG = dict(max_slots=2, page_size=4, pages_per_shard=32, max_len=64)
TTFT = [0.003, 0.04, 0.1, 0.12, 0.3, 0.7, 1.9, 3.2]
GAPS = [0.01, 0.02, 0.03, 0.05, 0.2]
# the fields whose values the two engines must share (the compile counters
# count jit traces in JAX and stay 0 in the port; wall seconds are clocks)
DETERMINISTIC = ("steps", "decode_steps", "prefills", "finished",
                 "tokens_out", "prefill_chunks", "prefill_tokens_computed",
                 "prefill_tokens_cached", "peak_pages", "pages_total",
                 "occupancy_sum", "prefix_evictions")
_CTX = {}


def test_latency_quantiles_equal_jax():
    got, want = EngineMetrics(), JaxEngineMetrics()
    for m in (got, want):
        for v in TTFT:
            m.observe_ttft(v)
        for v in GAPS:
            m.observe_intertoken(v)
    q = got.latency_quantiles()
    assert q == want.latency_quantiles()
    assert q["ttft_count"] == 8 and q["intertoken_count"] == 5
    # the bucket estimate, not the exact percentile of the raw values
    assert q["ttft_p50_s"] == 0.25
    got.reset(keep_compiles=True)
    want.reset(keep_compiles=True)
    assert got.latency_quantiles() == want.latency_quantiles()
    assert got.latency_quantiles()["ttft_count"] == 0


@pytest.mark.parametrize("buckets", ["TTFT_BUCKETS", "INTERTOKEN_BUCKETS"])
def test_histogram_matches_jax(buckets):
    assert getattr(obs, buckets) == getattr(jax_obs, buckets)
    last = getattr(obs, buckets)[-1]
    values = np.append(np.random.default_rng(0).lognormal(-3.0, 2.0, 200),
                       [2 * last, 10 * last])
    hs = []
    for mod in (obs, jax_obs):
        h = mod.Histogram("h_seconds", buckets=getattr(mod, buckets))
        for i, v in enumerate(values):
            h.observe(float(v), replica=str(i % 2))
        hs.append(h)
    mine, theirs = hs
    assert mine.bucket_counts() == theirs.bucket_counts()
    assert mine.bucket_counts()[-1] > 0          # some land past the bound
    for labels in ({}, {"replica": "1"}):
        assert mine.count(**labels) == theirs.count(**labels)
        for q in (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 1.0):
            assert mine.quantile(q, **labels) == theirs.quantile(q, **labels)
    # a gap past the last bound clamps to it
    assert mine.quantile(1.0) == mine.buckets[-1]
    with pytest.raises(ValueError, match="quantile"):
        mine.quantile(1.5)


def _drive_registry(mod):
    reg = mod.Registry()
    reg.counter("reqs_total", "requests").inc(3, model="a")
    reg.counter("reqs_total").set(7, model='b"\\x\nend')
    g = reg.gauge("pages", "pages in use")
    g.set(5, replica="0")
    g.set(3, replica="1")
    h = reg.histogram("serve_ttft_seconds", "ttft",
                      buckets=mod.TTFT_BUCKETS)
    for v in TTFT:
        h.observe(v, replica="0")
    h.observe(100.0, replica="1")
    return reg


def test_registries_render_and_parse_alike():
    mine, theirs = _drive_registry(obs), _drive_registry(jax_obs)
    text = mine.render_prometheus()
    assert text == theirs.render_prometheus()
    assert json.dumps(mine.to_json(), sort_keys=True) == json.dumps(
        theirs.to_json(), sort_keys=True)
    parsed = obs.parse_prometheus(text)
    assert parsed == jax_obs.parse_prometheus(text)
    assert parsed[("serve_ttft_seconds_count", (("replica", "0"),))] == 8
    assert parsed[("serve_ttft_seconds_bucket",
                   (("le", "+Inf"), ("replica", "1")))] == 1
    assert mine.value("pages", replica="1") == \
        theirs.value("pages", replica="1") == 3
    with pytest.raises(ValueError, match="already registered"):
        mine.gauge("reqs_total")
    with pytest.raises(ValueError, match="buckets"):
        mine.histogram("serve_ttft_seconds", buckets=(1.0, 2.0))


def test_tracer_async_events_match_jax():
    """The same calls on both tracers give the same Chrome-trace events
    but for the clock, pid and tid; a cleared tracer starts empty."""
    seen = []
    for mod in (obs, jax_obs):
        tr = mod.Tracer(enabled=True)
        a = tr.async_begin("request", uid="a", prompt_len=5, max_new=3)
        with tr.span("engine/step", cat="engine", step=0):
            b = tr.async_begin("request", cat="gw", uid="b")
        tr.async_end("request", a, tokens=3)
        tr.async_end("request", b, cat="gw")
        tr.async_end("request", None)           # never opened: nothing
        seen.append([{k: v for k, v in e.items()
                      if k not in ("ts", "dur", "pid", "tid")}
                     for e in tr.events()])
        tr.clear()
        assert tr.events() == []
    assert seen[0] == seen[1]
    assert [e["ph"] for e in seen[0]] == ["b", "b", "X", "e", "e"]
    assert seen[0][3] == {"name": "request", "cat": "request", "ph": "e",
                          "id": seen[0][0]["id"], "args": {"tokens": 3}}


def _requests(vocab, cls):
    """Two prompts sharing a two-page prefix, an unrelated one, and a
    third sharer that joins mid-run."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, 8).tolist()
    return [cls("a", shared + rng.integers(0, vocab, 5).tolist(), 4),
            cls("c", rng.integers(0, vocab, 7).tolist(), 3),
            cls("b", shared + rng.integers(0, vocab, 6).tolist(), 5),
            cls("late", shared + rng.integers(0, vocab, 2).tolist(), 3)]


def _drive(eng, reqs):
    for r in reqs[:-1]:
        assert eng.add_request(r) is None
    eng.step()
    assert eng.add_request(reqs[-1]) is None     # joins the running batch
    return eng.run()


def _ctx():
    if not _CTX:
        cfg = jax_registry.get_smoke(ARCH)
        plan = jax_make_serve_plan(
            cfg, arch=ARCH, n_devices=1, c=1, decode_batch=ENG["max_slots"],
            page_size=ENG["page_size"], max_len=ENG["max_len"],
            prefix_cache=True)
        jmodel = jax_build_model(cfg)
        jeng = jax_engine.Engine(
            jmodel, plan, jax_engine.EngineConfig(**ENG),
            jmodel.init(jax.random.PRNGKey(0)), registry=jax_obs.Registry(),
            tracer=jax_obs.Tracer(enabled=True))
        j_out = _drive(jeng, _requests(cfg.vocab_size, jax_engine.Request))
        model = from_jax_params(jax.tree.map(np.asarray, jeng.params), cfg,
                                "cpu")
        t_plan = make_serve_plan(
            cfg, arch=ARCH, c=1, decode_batch=ENG["max_slots"],
            page_size=ENG["page_size"], max_len=ENG["max_len"],
            prefix_cache=True)
        teng = torch_engine.Engine(
            model, t_plan, torch_engine.EngineConfig(**ENG),
            registry=obs.Registry(), tracer=obs.Tracer(enabled=True))
        t_out = _drive(teng, _requests(cfg.vocab_size, torch_engine.Request))
        _CTX.update(jeng=jeng, teng=teng, j_out=j_out, t_out=t_out)
    return _CTX


def _families(reg):
    """{metric name: (kind, sorted label sets of its series)} from the
    registry's JSON."""
    return {name: (fam["kind"], sorted(json.dumps(s["labels"],
                                                  sort_keys=True)
                                       for s in fam["series"]))
            for name, fam in reg.to_json().items()}


def test_engine_metrics_match_jax_engine():
    ctx = _ctx()
    jeng, teng = ctx["jeng"], ctx["teng"]
    assert ctx["t_out"] == ctx["j_out"]
    assert teng.metrics.prefill_tokens_cached > 0        # the prefix hit
    mine, theirs = _families(teng.registry), _families(jeng.registry)
    # both engines' connectors put their ten host KV tier series
    # (``kv_transfer_*``, ``host_tier_*``) in the registry, tier off or on
    host_tier = {n for n in theirs if n.startswith(("kv_", "host_tier_"))}
    assert len(host_tier) == 10
    assert host_tier <= set(mine)
    port_only = {"engine_prefill_wall_seconds", "engine_decode_wall_seconds"}
    assert set(mine) == set(theirs) | port_only
    for name in port_only:
        assert mine[name] == ("gauge", [json.dumps({})])
    compiles = {f"engine_{k}_compiles_total"
                for k in ("prefill", "decode", "transfer")}
    for name in theirs:
        kind, labels = theirs[name]
        assert mine[name][0] == kind, name
        if name not in compiles:
            assert mine[name][1] == labels, name
    got, want = teng.metrics.to_dict(), jeng.metrics.to_dict()
    for field in DETERMINISTIC:
        assert got[field] == want[field], field
    for key in ("occupancy", "page_utilization", "prefix_hit_rate"):
        assert got[key] == want[key], key
    q_mine = teng.metrics.latency_quantiles()
    q_theirs = jeng.metrics.latency_quantiles()
    for short in ("ttft", "intertoken"):
        assert q_mine[f"{short}_count"] == q_theirs[f"{short}_count"] > 0
    m = teng.metrics
    assert q_mine["ttft_count"] == m.prefills
    assert q_mine["intertoken_count"] == m.tokens_out - m.prefills


def test_engine_trace_matches_jax_engine():
    ctx = _ctx()
    mine = [(e["name"], e["cat"], e["ph"])
            for e in ctx["teng"].tracer.events()]
    theirs = [(e["name"], e["cat"], e["ph"])
              for e in ctx["jeng"].tracer.events()]
    assert mine == theirs
    events = ctx["teng"].tracer.events()
    begins = {e["id"]: e for e in events if e["ph"] == "b"}
    ends = {e["id"]: e for e in events if e["ph"] == "e"}
    assert set(begins) == set(ends) and len(begins) == 4
    assert sorted(e["args"]["uid"] for e in begins.values()) == \
        ["a", "b", "c", "late"]
    assert sum(e["args"]["tokens"] for e in ends.values()) == \
        ctx["teng"].metrics.tokens_out
    steps = [e for e in events if e["name"] == "engine/step"]
    assert len(steps) == ctx["teng"].metrics.steps
    assert [e["args"]["step"] for e in steps] == list(range(len(steps)))
    # a disabled tracer records nothing
    assert obs.NULL_TRACER.async_begin("request") is None
    assert obs.NULL_TRACER.events() == []


def test_launch_serve_metrics_dump_and_trace_out(tmp_path):
    from repro_torch.launch import serve

    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
            "3", "--prompt-len", "6", "--gen", "4", "--temperature", "0.8",
            "--top-k", "40", "--top-p", "0.9"]
    out = serve.main(argv + ["--metrics-dump", str(tmp_path / "m.prom"),
                             "--trace-out", str(tmp_path / "trace.json")])
    n_tok = sum(len(v) for v in out.values())
    text = (tmp_path / "m.prom").read_text()
    parsed = obs.parse_prometheus(text)
    assert parsed == jax_obs.parse_prometheus(text)
    assert parsed[("engine_tokens_out_total", ())] == n_tok
    assert parsed[("serve_ttft_seconds_count", ())] == 3
    assert parsed[("serve_intertoken_seconds_count", ())] == n_tok - 3
    trace = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert sum(e["ph"] == "b" for e in trace) == 3
    assert sum(e["ph"] == "e" for e in trace) == 3
    again = serve.main(argv + ["--metrics-dump", str(tmp_path / "m.json")])
    assert again == out                  # the same seeds, the same streams
    dumped = json.loads((tmp_path / "m.json").read_text())
    assert dumped["serve_ttft_seconds"]["kind"] == "histogram"
    assert dumped["serve_ttft_seconds"]["series"][0]["count"] == 3
