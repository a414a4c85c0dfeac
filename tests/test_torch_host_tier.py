"""repro_torch's engine with the pinned-host KV tier, the prefill -> decode
handoff and preemption, against the JAX engine on the same weights.

Smoke h2o-danube-1.8b; the JAX engine (one CPU device, P = 1) makes the
weights and ``from_jax_params`` carries them into the port's engines on the
CPU. Every comparison below is exact: token streams and the connector's
``stats()``.

* The pool-pressure sequence of ``check_gateway_prefix_cow``'s host-tier
  run: a family prompt, two deeper evictor prompts that make the
  cost-aware eviction unwind the family chain (spilled to the tier), then
  the family again with a new tail (reloaded from the tier). A roomy pool
  that never evicts, the tight pool with the tier and the tight pool
  without it serve the same streams in both packages, and the tier's
  counters equal the JAX connector's.
* Two engines hand off: a prefill engine takes 1-token ``handoff`` twins,
  the caller exports, releases and ``add_prefilled``s each into a decode
  engine, as the JAX gateway does; the streams equal a unified engine's and
  the JAX pair's.
* ``preempt`` of a queued, a mid-decode and a mid-chunk request at the same
  step in both packages, each resumed: the resumed streams equal the JAX
  engine's and the uninterrupted run's. A sampled request preempted
  mid-decode resumes into its uninterrupted stream.
* The same sequence with a tier of 2 pages: the family's later spills find
  the tier full and ask the cost model (``Engine._spill_worthwhile``, that
  is ``plan.cost.spill_decision``, on the JAX table's constants in the
  port), which refuses them in both packages; streams and ``stats()``
  equal JAX's.
* The pressure sequence at c = 2 (``ThreadMesh(2, 1)``) and with 2 data
  replicas of SP degree 2: streams equal JAX's, counters equal the JAX
  engine's at the same layout (run in a child process with 4 forced host
  devices, started first so it overlaps the rest), the tight pool holding
  8 pages in all.
* ``launch.serve --prefix-cache --host-tier-bytes`` on the CPU.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro import engine as jax_engine
from repro.configs import registry as jax_registry
from repro.models.factory import build_model as jax_build_model
from repro.plan import make_serve_plan as jax_make_serve_plan
from repro.roofline import hw as jax_hw
from repro_torch import engine as torch_engine
from repro_torch.core import scheduler as sch
from repro_torch.models.factory import from_jax_params
from repro_torch.plan import make_serve_plan
from repro_torch.roofline import hw

ARCH = "h2o-danube-1.8b"
ROOMY = dict(max_slots=2, page_size=4, pages_per_shard=32, max_len=64)
TIGHT = dict(ROOMY, pages_per_shard=8)
TIER = 64 << 20
# (name, n_devices, data, c) of the SP layouts the tier runs at
LAYOUTS = (("c2", 4, 1, 2), ("data2", 4, 2, 1))


def _pressure_requests(vocab, cls):
    """The family, two evictors (24 fresh tokens: deeper, so costlier, than
    the family's 16) and the family again with a new tail."""
    rng = np.random.default_rng(17)
    fam = rng.integers(0, vocab, 16).tolist()
    return [cls("h0", fam + rng.integers(0, vocab, 3).tolist(), 3),
            *[cls(f"e{i}", rng.integers(0, vocab, 24).tolist(), 1)
              for i in range(2)],
            cls("h1", fam + rng.integers(0, vocab, 5).tolist(), 3)]


def _serve_pressure(eng, reqs):
    out = {}
    for r in reqs:
        assert eng.add_request(r) is None
        out.update(eng.run())
    return out


def _handoff_requests(vocab, cls):
    rng = np.random.default_rng(5)
    return [cls(f"p{i}", rng.integers(0, vocab, n).tolist(), m)
            for i, (n, m) in enumerate([(9, 4), (13, 3), (6, 5), (11, 1)])]


def _serve_handoff(pre, dec, reqs):
    """The JAX gateway's drive: 1-token handoff twins on ``pre``; each
    finished twin exported, released and added to ``dec`` (a 1-token
    budget needs no handoff). Returns the streams and the exported block
    counts."""
    for r in reqs:
        assert pre.add_request(dataclasses.replace(
            r, max_new_tokens=1, handoff=True)) is None
    by_uid = {r.uid: r for r in reqs}
    first, exported = {}, {}
    while not (pre.idle() and dec.idle()):
        for eng in (pre, dec):
            if not eng.idle():
                eng.step()
        for st in pre.take_handoffs():
            orig = by_uid[st.req.uid]
            first[orig.uid] = st.out[0]
            if orig.max_new_tokens > 1:
                blocks = pre.export_kv(st)
                exported[orig.uid] = len(blocks)
                pre.release_handoff(st)
                dec.add_prefilled(orig, st.out[0], blocks)
            else:
                pre.release_handoff(st)
    out = dec.collect()
    return {u: (out[u] if u in out else [first[u]]) for u in by_uid}, \
        exported


def _preempt_requests(vocab, cls):
    rng = np.random.default_rng(9)
    return [cls("d", rng.integers(0, vocab, 6).tolist(), 6),
            cls("c", rng.integers(0, vocab, 21).tolist(), 4),
            cls("q", rng.integers(0, vocab, 7).tolist(), 3)]


def _serve_preempted(eng, reqs, at=2, uids=("q", "d", "c")):
    """Queue ``reqs``, step ``at`` times, preempt ``uids`` (in order), add
    their resume requests back and run to the end. Returns the full
    streams (tokens before the preemption + after) and the resumes."""
    for r in reqs:
        assert eng.add_request(r) is None
    for _ in range(at):
        eng.step()
    before, resumes = {}, {}
    for uid in uids:
        st = next((s for s in eng.scheduler.active() if s.req.uid == uid),
                  None)
        before[uid] = list(st.out) if st is not None else []
        resumes[uid] = eng.preempt(uid)
        assert resumes[uid] is not None, uid
    for uid in uids:
        assert eng.add_request(resumes[uid]) is None
    out = eng.run()
    return {r.uid: before.get(r.uid, []) + out[r.uid] for r in reqs}, resumes


def _jax_engine(jmodel, params, eng, prefix=True, tier=0, chunk=0):
    plan = jax_make_serve_plan(
        jmodel.cfg, arch=ARCH, n_devices=1, c=1, decode_batch=eng["max_slots"],
        page_size=eng["page_size"], max_len=eng["max_len"],
        prefix_cache=prefix, host_tier_bytes=tier)
    return jax_engine.Engine(jmodel, plan, jax_engine.EngineConfig(
        **eng, prefill_chunk=chunk), params)


def _torch_engine(model, eng, prefix=True, tier=0, chunk=0, n_devices=1,
                  data=1, c=1):
    plan = make_serve_plan(
        model.cfg, arch=ARCH, n_devices=n_devices, data=data, c=c,
        decode_batch=eng["max_slots"], page_size=eng["page_size"],
        max_len=eng["max_len"], prefix_cache=prefix, host_tier_bytes=tier)
    return torch_engine.Engine(model, plan, torch_engine.EngineConfig(
        **eng, prefill_chunk=chunk))


def _tight(n_devices, data):
    """The tight pool of 8 pages spread over the SP shards."""
    return dict(TIGHT, pages_per_shard=8 * data // n_devices)


@pytest.fixture(scope="module")
def ctx():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(root, "src"))
    proc = subprocess.Popen([sys.executable, "-c", _JAX_LAYOUTS], cwd=root,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        yield _run_both(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _run_both(proc):
    cfg = jax_registry.get_smoke(ARCH)
    jmodel = jax_build_model(cfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg, "cpu")
    vocab = cfg.vocab_size
    out = {}
    for pkg, make, cls in (
            ("jax", lambda **kw: _jax_engine(jmodel, params, **kw),
             jax_engine.Request),
            ("torch", lambda **kw: _torch_engine(model, **kw),
             torch_engine.Request)):
        roomy = make(eng=ROOMY)
        tier = make(eng=TIGHT, tier=TIER)
        off = make(eng=TIGHT)
        reqs = _pressure_requests(vocab, cls)
        res = {name: _serve_pressure(e, reqs)
               for name, e in (("roomy", roomy), ("tier", tier),
                               ("off", off))}
        res["tier_stats"] = tier.connector.stats()
        res["page_bytes"] = tier.connector.page_bytes
        res["off_stats"] = off.connector.stats()
        res["tier_metrics"] = tier.metrics.to_dict()
        # handoff: the roomy engine unified, then prefill -> tier-off engine
        hreqs = _handoff_requests(vocab, cls)
        roomy.reset()
        for r in hreqs:
            assert roomy.add_request(r) is None
        res["unified"] = roomy.run()
        roomy.reset()
        off.reset()
        res["handoff"], res["exported"] = _serve_handoff(roomy, off, hreqs)
        res["pre_stats"] = roomy.connector.stats()
        res["dec_stats"] = off.connector.stats()
        res["dec_metrics"] = off.metrics.to_dict()
        res["pre_metrics"] = roomy.metrics.to_dict()
        # preemption on a chunked engine, against its uninterrupted run
        chunked = make(eng=ROOMY, chunk=8)
        preqs = _preempt_requests(vocab, cls)
        for r in preqs:
            assert chunked.add_request(r) is None
        res["whole"] = chunked.run()
        chunked.reset()
        res["preempted"], res["resumes"] = _serve_preempted(chunked, preqs)
        res["preempt_metrics"] = chunked.metrics.to_dict()
        out[pkg] = res
        if pkg == "torch":
            out["engines"] = dict(roomy=roomy, tier=tier, off=off,
                                  chunked=chunked)
    return dict(out, cfg=cfg, model=model, proc=proc, jmodel=jmodel,
                params=params)


def test_pressure_streams_and_counters_equal_jax(ctx):
    got, want = ctx["torch"], ctx["jax"]
    assert got["roomy"] == want["roomy"]
    assert got["tier"] == got["off"] == got["roomy"] == want["tier"] \
        == want["off"]
    assert got["tier_stats"] == want["tier_stats"]
    assert got["off_stats"] == want["off_stats"]
    tier = got["tier_stats"]
    assert tier["spill_pages"] >= 4 and tier["reload_pages"] >= 4, tier
    assert tier["hit_tokens"] >= 16 and tier["hit_rate"] > 0, tier
    assert got["off_stats"]["hit_tokens"] == 0
    for key in ("prefill_tokens_host", "prefill_tokens_cached",
                "prefill_tokens_computed", "prefix_evictions"):
        assert got["tier_metrics"][key] == want["tier_metrics"][key], key
    assert got["tier_metrics"]["prefill_tokens_host"] == 16


def test_spill_refused_under_pressure_equals_jax(ctx, monkeypatch):
    # the JAX table's rates and cluster in the port's cost model
    monkeypatch.setattr(hw, "HBM_BW", jax_hw.HBM_BW)
    monkeypatch.setattr(hw, "HOST_LINK_BW", jax_hw.HOST_LINK_BW)
    monkeypatch.setattr(sch, "ClusterModel", functools.partial(
        sch.ClusterModel, peak_flops=jax_hw.PEAK_FLOPS_BF16,
        link_bw=jax_hw.ICI_BW_PER_LINK))
    vocab = ctx["cfg"].vocab_size
    res = {}
    for pkg, make, cls in (
            ("jax", lambda **kw: _jax_engine(ctx["jmodel"], ctx["params"],
                                             **kw), jax_engine.Request),
            ("torch", lambda **kw: _torch_engine(ctx["model"], **kw),
             torch_engine.Request)):
        eng = make(eng=TIGHT, tier=2 * ctx[pkg]["page_bytes"])
        streams = _serve_pressure(eng, _pressure_requests(vocab, cls))
        res[pkg] = streams, eng.connector.stats()
    (got, stats), (want, want_stats) = res["torch"], res["jax"]
    assert got == want == ctx["jax"]["roomy"]
    assert stats == want_stats
    assert stats["capacity_pages"] == 2 and stats["spills_skipped"] > 0, \
        stats
    assert stats["spill_pages"] == 2, stats


def test_handoff_between_engines_equals_unified_and_jax(ctx):
    got, want = ctx["torch"], ctx["jax"]
    assert got["handoff"] == got["unified"] == want["handoff"] \
        == want["unified"]
    assert got["exported"] == want["exported"] == \
        {"p0": 3, "p1": 4, "p2": 2}
    for key in ("pre_stats", "dec_stats"):
        assert got[key] == want[key], key
    pages = sum(got["exported"].values())
    assert got["pre_stats"]["handoff_out_pages"] == pages
    assert got["dec_stats"]["handoff_in_pages"] == pages
    for key in ("handoffs_out", "prefills", "tokens_out"):
        assert got["pre_metrics"][key] == want["pre_metrics"][key], key
    for key in ("handoffs_in", "prefills", "decode_steps", "tokens_out",
                "finished"):
        assert got["dec_metrics"][key] == want["dec_metrics"][key], key
    assert got["pre_metrics"]["handoffs_out"] == 4
    assert got["dec_metrics"]["handoffs_in"] == 3
    assert got["dec_metrics"]["prefills"] == 0       # no prefill decoded


def test_preempt_resumes_equal_jax_and_uninterrupted(ctx):
    got, want = ctx["torch"], ctx["jax"]
    assert got["preempted"] == want["preempted"] == got["whole"] \
        == want["whole"]
    for uid in ("q", "d", "c"):
        g, w = got["resumes"][uid], want["resumes"][uid]
        assert (g.tokens, g.max_new_tokens) == (w.tokens, w.max_new_tokens)
    # the queued and the mid-chunk request come back as they went in; the
    # mid-decode one as its prompt + tokens so far with the rest of its budget
    d = got["resumes"]["d"]
    assert len(d.tokens) > 6 and d.max_new_tokens < 6
    assert got["resumes"]["c"].max_new_tokens == 4
    for key in ("preemptions", "prefill_tokens_cached",
                "prefill_tokens_computed", "prefills", "tokens_out"):
        assert got["preempt_metrics"][key] == want["preempt_metrics"][key], \
            key
    assert got["preempt_metrics"]["preemptions"] == 3
    # the mid-decode and mid-chunk resumes hit their registered blocks
    assert got["preempt_metrics"]["prefill_tokens_cached"] > 0


def test_preempt_sampled_and_refusals(ctx):
    eng = ctx["engines"]["chunked"]
    vocab = ctx["cfg"].vocab_size
    reqs = [dataclasses.replace(r, temperature=0.8, top_k=40, top_p=0.9,
                                seed=7 + i)
            for i, r in enumerate(_preempt_requests(vocab,
                                                    torch_engine.Request))]
    eng.reset()
    for r in reqs:
        assert eng.add_request(r) is None
    whole = eng.run()
    eng.reset()
    got, _ = _serve_preempted(eng, reqs, at=3, uids=("d",))
    assert got == whole
    assert eng.preempt("nope") is None
    # a finished handoff slot is pinned for its export: preempt refuses it
    eng.reset()
    assert eng.add_request(dataclasses.replace(
        reqs[0], max_new_tokens=1, handoff=True)) is None
    eng.step()
    assert eng.preempt("d") is None
    st, = eng.take_handoffs()
    eng.release_handoff(st)
    assert eng.idle()


_JAX_LAYOUTS = r"""
import json, sys
import numpy as np
from repro import engine as jax_engine
from repro.configs import registry
from repro.plan import make_serve_plan
sys.path.insert(0, "tests")
from test_torch_host_tier import (ARCH, LAYOUTS, TIER, _pressure_requests,
                                  _serve_pressure, _tight)
cfg = registry.get_smoke(ARCH)
out = {}
for name, n, data, c in LAYOUTS:
    eng_kw = _tight(n, data)
    plan = make_serve_plan(
        cfg, arch=ARCH, n_devices=n, data=data, c=c,
        decode_batch=eng_kw["max_slots"], page_size=eng_kw["page_size"],
        max_len=eng_kw["max_len"], mesh_kind="local", prefix_cache=True,
        host_tier_bytes=TIER)
    eng = jax_engine.build_engine(ARCH, smoke=True, plan=plan,
                                  eng=jax_engine.EngineConfig(**eng_kw))
    streams = _serve_pressure(eng, _pressure_requests(cfg.vocab_size,
                                                      jax_engine.Request))
    out[name] = {"streams": streams, "stats": eng.connector.stats()}
print(json.dumps(out))
"""


def test_host_tier_at_c2_and_data2_equals_jax(ctx):
    stdout, stderr = ctx["proc"].communicate(timeout=300)
    assert ctx["proc"].returncode == 0, stderr[-4000:]
    want = json.loads(stdout.strip().splitlines()[-1])
    reqs = _pressure_requests(ctx["cfg"].vocab_size, torch_engine.Request)
    for name, n, data, c in LAYOUTS:
        eng = _torch_engine(ctx["model"], _tight(n, data), tier=TIER,
                            n_devices=n, data=data, c=c)
        assert len(eng.pools) == 4 and eng.sp == n // data
        streams = _serve_pressure(eng, reqs)
        assert streams == want[name]["streams"] == ctx["jax"]["roomy"], name
        stats = eng.connector.stats()
        assert stats == want[name]["stats"], name
        assert stats["reload_pages"] >= 4 and stats["hit_tokens"] >= 16
        if data > 1:        # both replicas' pools received every reload
            for s in range(eng.sp):
                r0, r1 = eng._shards[s]
                for k in ("k", "v"):
                    assert r0[k].equal(r1[k]), (s, k)


def test_launch_serve_host_tier(capsys):
    from repro_torch.launch import serve

    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--prefix-cache",
            "--pages-per-shard", "8"]
    off = serve.main(argv)
    capsys.readouterr()
    on = serve.main(argv + ["--host-tier-bytes", str(1 << 20)])
    text = capsys.readouterr().out
    assert on == off
    # --prefix-cache serves through the gateway (one replica), which
    # prints each replica's connector stats
    head = "[gateway]   replica 0 host tier: "
    line = next(s for s in text.splitlines() if s.startswith(head))
    fields = dict(kv.split("=") for kv in line[len(head):].split(", "))
    assert int(fields["capacity_pages"]) == 256
    assert int(fields["spill_pages"]) > 0
    assert "host_tier_bytes=1048576" in text
    with pytest.raises(ValueError, match="prefix_cache"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--host-tier-bytes", "1024"])
