"""repro_torch's serving gateway against the JAX package's.

Smoke h2o-danube-1.8b; the JAX package draws the weights and
``from_jax_params`` carries them into the port's model on the CPU. Token
streams, placements and counters are compared exactly; every request in a
comparison across packages is greedy (the port's sampling noise is not
JAX's threefry, ``engine.sampling``).

* The router (``gateway.router``): prefix first, then load, then index;
  session affinity; liveness; and the JAX router's choices on one seeded
  sequence of stub replicas. The prefix cache's ``match_len`` and
  ``drop_all`` against the JAX trie's.
* One replica in process: the port's ``Gateway`` and the JAX ``Gateway``
  on the same weights give the same streams, owners, ``routed``,
  ``affinity_hits``, ``metrics_dict()`` (less its wall-clock fields and
  ``pallas_fallbacks``) and ``stats()['host_tier']``.
* Two replicas, and prefill/decode roles, at C = 1 against JAX gateways in
  one child process with 2 forced host devices (started first, so it
  overlaps the rest).
* The layouts of the JAX ``check_gateway_prefix_cow``, ``_replicas`` and
  ``_disagg`` at C = 2 on ``ThreadMesh`` ranks, their assertions ported;
  the streams are held against the port's own engine, which
  ``test_torch_engine_sp.py`` holds against JAX.
* ``decode_step_cost``, ``serve_slo_cost`` and ``prefix_cache_value``
  (every field) on the
  13 configs at SP 1-8 under the JAX constants ('cuda' for JAX's
  'pallas'); ``make_role_plans`` against JAX's.
* ``launch.serve --replicas 2 --prefix-cache`` and ``--roles
  prefill,decode`` on the CPU.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro import gateway as jax_gateway
from repro.configs import paper_models
from repro.configs import registry as jax_registry
from repro.core import scheduler as jax_sch
from repro.engine import EngineConfig as JaxEngineConfig
from repro.engine import Request as JaxRequest
from repro.engine.paged_cache import PagePool as JaxPagePool
from repro.gateway.prefix_cache import PrefixCache as JaxPrefixCache
from repro.gateway.router import Router as JaxRouter
from repro.models.factory import build_model as jax_build_model
from repro.plan import cost as jax_cost
from repro.plan import make_role_plans as jax_make_role_plans
from repro.plan import make_serve_plan as jax_make_serve_plan
from repro.roofline import hw as jax_hw
from repro_torch.configs import base as tbase
from repro_torch.configs import registry
from repro_torch.core import scheduler as sch
from repro_torch.engine import Engine, EngineConfig, PagePool, Request
from repro_torch.gateway import Gateway, PrefixCache, Router, build_gateway
from repro_torch.models.factory import from_jax_params
from repro_torch.plan import cost, make_role_plans, make_serve_plan
from repro_torch.roofline import hw

ARCH = "h2o-danube-1.8b"
EC = dict(max_slots=2, page_size=4, pages_per_shard=32, max_len=64)
TIER = 64 << 20
# metrics_dict keys that are host wall clock, count JAX's compiles (the
# port compiles nothing), or have no counterpart in the other package
SKIP = {"wall_s", "tokens_per_s", "pallas_fallbacks", "prefill_wall_s",
        "decode_wall_s", "prefill_compiles", "decode_compiles",
        "transfer_compiles"}


# ---------------------------------------------------------------------------
# the router on stub replicas
# ---------------------------------------------------------------------------

class _StubSched:
    def __init__(self):
        self.queue = []

    def active(self):
        return []


class _StubEngine:
    """What the router reads of an engine: its scheduler's load and its
    prefix cache's ``match_len``."""

    page_size = 4

    def __init__(self, cached):
        self._cached = cached
        self.scheduler = _StubSched()
        self.prefix_cache = self

    def hashes(self, tokens):
        return tokens

    def match_len(self, hashes):
        return self._cached


def test_router_prefers_prefix_then_load_then_index():
    a, b = _StubEngine(cached=0), _StubEngine(cached=2)
    r = Router([a, b])
    req = Request("x", [1, 2, 3, 4, 5, 6, 7, 8], 2)
    assert r.route(req) == 1                # 8 cached tokens beat empty
    b._cached = 0
    assert r.route(req) == 0                # tie -> lower index
    a.scheduler.queue = [req]               # load on a
    assert r.route(req) == 1
    assert r.routed == [1, 2]


def test_router_session_affinity_sticks():
    a, b = _StubEngine(0), _StubEngine(0)
    r = Router([a, b])
    req = Request("x", [1] * 8, 2)
    first = r.route(req, session="s")
    b._cached = 99                          # would win without affinity
    assert r.route(req, session="s") == first
    assert r.affinity_hits == 1


def test_router_liveness():
    a, b = _StubEngine(2), _StubEngine(0)
    r = Router([a, b], eligible=[0, 1])
    req = Request("x", [1] * 8, 2)
    assert r.route(req, session="s") == 0
    r.mark_dead(0)
    assert r.live_eligible() == [1] and "s" not in r.affinity
    assert r.route(req, session="s") == 1   # re-routed on next use
    r.mark_dead(1)
    with pytest.raises(RuntimeError, match="no live"):
        r.route(req)


def test_router_equals_jax():
    """One seeded sequence of cached prefixes, loads, sessions and a death
    through both routers: the same choices and counters."""
    rng = np.random.default_rng(0)
    stubs = [[_StubEngine(0) for _ in range(3)] for _ in range(2)]
    routers = [Router(stubs[0], eligible=[0, 1, 2]),
               JaxRouter(stubs[1], eligible=[0, 1, 2])]
    picks = [[], []]
    for step in range(60):
        cached = rng.integers(0, 3, 3)
        loads = rng.integers(0, 3, 3)
        session = f"s{rng.integers(0, 4)}" if rng.random() < 0.5 else None
        for k, (router, cls) in enumerate(zip(routers,
                                              (Request, JaxRequest))):
            for s, c, n in zip(stubs[k], cached, loads):
                s._cached = int(c)
                s.scheduler.queue = [cls("q", [1] * 4, 1)] * int(n)
            if step == 30:
                router.mark_dead(1)
            picks[k].append(router.route(cls("x", [1] * 8, 2), session))
    assert picks[0] == picks[1]
    assert routers[0].routed == routers[1].routed
    assert routers[0].affinity_hits == routers[1].affinity_hits > 0


def test_prefix_cache_match_len_and_drop_all_equal_jax():
    caches = []
    for pool_cls, cache_cls in ((PagePool, PrefixCache),
                                (JaxPagePool, JaxPrefixCache)):
        pool = pool_cls(2, 8)
        cache = cache_cls(pool, page_size=4, sp=2)
        toks = list(range(1, 17))
        pages = [pool.alloc(b % 2) for b in range(4)]
        cache.insert(cache.hashes(toks), [(b % 2, p)
                                          for b, p in enumerate(pages)])
        hit = cache.acquire(cache.hashes(toks[:8] + [99] * 8))
        lens = [cache.match_len(cache.hashes(t)) for t in
                (toks, toks[:12], toks[:7], [5] + toks[1:], [])]
        cache.drop_all()
        caches.append((lens, hit, cache.evicted_pages,
                       cache.match_len(cache.hashes(toks)),
                       pool.pages_in_use(), cache.stats()))
    assert caches[0] == caches[1]
    assert caches[0][0] == [4, 3, 1, 0, 0]
    # the trie is empty; the allocating holds keep the 4 pages in use
    assert caches[0][2] == 0 and caches[0][3] == 0 and caches[0][4] == 4


# ---------------------------------------------------------------------------
# the gateway against the JAX gateway on the same weights
# ---------------------------------------------------------------------------

def _family_requests(vocab, cls, n=6, gen=(3, 4, 5)):
    """Two families, each behind its own 16-token system prompt (one
    session each), request i in family i % 2, greedy."""
    rng = np.random.default_rng(5)
    shared = [rng.integers(0, vocab, 16).tolist() for _ in range(2)]
    return [cls(f"r{i}", shared[i % 2]
                + rng.integers(0, vocab, 3 + i).tolist(), gen[i % 3])
            for i in range(n)]


def _role_requests(vocab, cls):
    rng = np.random.default_rng(7)
    return [cls("g", rng.integers(0, vocab, 11).tolist(), 4),
            cls("s", rng.integers(0, vocab, 17).tolist(), 5),
            cls("one", rng.integers(0, vocab, 5).tolist(), 1),
            cls("g2", rng.integers(0, vocab, 6).tolist(), 3)]


def _drive(gw, reqs, sessions=True):
    """One request added per gateway step (the launcher's drive), then
    run to the end; returns streams, owners and the comparable stats."""
    owners = []
    for i, r in enumerate(reqs):
        owners.append(gw.add_request(
            r, session=f"sess{i % 2}" if sessions else None))
        gw.step()
    out = gw.run()
    st = gw.stats()
    per = [{k: v for k, v in m.items() if k not in SKIP}
           for m in st.pop("per_replica")]
    return {"out": out, "owners": owners, "owner": dict(gw._owner),
            "stats": {k: v for k, v in st.items() if k not in SKIP},
            "per": per}


def _common(got, want):
    """``got``'s per-replica metrics on ``want``'s keys (the port's engine
    metrics have two more wall-clock gauges, in ``SKIP``)."""
    return [{k: g[k] for k in w} for g, w in zip(got, want)]


_JAX_CHILD = r"""
import json, sys
import jax
sys.path.insert(0, "tests")
from repro.engine import EngineConfig, Request
from repro.gateway import build_gateway
from test_torch_gateway import (ARCH, EC, TIER, _drive, _family_requests,
                                _role_requests)
assert len(jax.devices()) == 2
out = {}
gw = build_gateway(ARCH, smoke=True, c=1, replicas=2, prefix_cache=True,
                   eng=EngineConfig(**EC))
assert [e.mesh.devices.size for e in gw.engines] == [1, 1]
out["replicas"] = _drive(gw, _family_requests(gw.cfg.vocab_size, Request))
gw = build_gateway(ARCH, smoke=True, c=1, roles=["prefill", "decode"],
                   prefix_cache=True, host_tier_bytes=TIER,
                   eng=EngineConfig(**EC))
out["roles"] = _drive(gw, _role_requests(gw.cfg.vocab_size, Request),
                      sessions=False)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_child():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.path.join(root, "src"))
    proc = subprocess.Popen([sys.executable, "-c", _JAX_CHILD], cwd=root,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        yield proc
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def ctx(jax_child):
    cfg = jax_registry.get_smoke(ARCH)
    jmodel = jax_build_model(cfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    model = from_jax_params(jax.tree.map(np.asarray, params),
                            registry.get_smoke(ARCH), "cpu")
    return dict(cfg=cfg, jmodel=jmodel, params=params, model=model,
                child=jax_child)


def _jax_one_replica(ctx, prefix=True, tier=0):
    plan = jax_make_serve_plan(
        ctx["cfg"], arch=ARCH, n_devices=1, c=1,
        decode_batch=EC["max_slots"], page_size=EC["page_size"],
        max_len=EC["max_len"], mesh_kind="local", prefix_cache=prefix,
        host_tier_bytes=tier)
    return jax_gateway.Gateway(ctx["jmodel"], plan, JaxEngineConfig(**EC),
                               ctx["params"])


def _torch_gateway(ctx, **kw):
    kw.setdefault("prefix_cache", True)
    return build_gateway(ARCH, smoke=True, c=1, eng=EngineConfig(**EC),
                         model=ctx["model"], device="cpu", **kw)


def test_gateway_single_device_prefix_cache_end_to_end(ctx):
    gw = _torch_gateway(ctx)
    jgw = _jax_one_replica(ctx)
    vocab = ctx["cfg"].vocab_size
    got = _drive(gw, _family_requests(vocab, Request))
    want = _drive(jgw, _family_requests(vocab, JaxRequest))
    assert got["out"] == want["out"]
    assert got["owners"] == want["owners"] == [0] * 6
    assert got["stats"] == want["stats"]
    assert got["stats"]["affinity_hits"] == 4
    assert got["stats"]["prefill_tokens_cached"] == 64   # 4 hits of 16
    assert _common(got["per"], want["per"]) == want["per"]
    # streaming: every request's stream drains to its full output
    reqs = _family_requests(vocab, Request)
    assert all(gw.take(r.uid) == got["out"][r.uid] for r in reqs)
    assert gw.take(reqs[0].uid) == []
    # equal to cold-cache solo serving
    cold = _torch_gateway(ctx, prefix_cache=False)
    for r in reqs:
        cold.reset()
        assert cold.add_request(r) == 0
        assert cold.run()[r.uid] == got["out"][r.uid], r.uid
    # replay after reset: same streams, nothing compiled
    gw.reset()
    for r in reqs:
        gw.add_request(r)
    assert gw.run() == got["out"]
    assert gw.compiles() == (0, 0)
    q = gw.latency_quantiles()
    assert q["ttft_count"] == 6 and q["ttft_p50_s"] > 0   # since reset
    # draining: typed rejection, and shutdown flushes and collects
    assert gw.shutdown() == gw.collect()
    rej = gw.add_request(reqs[0])
    assert not isinstance(rej, int) and rej.reason == "draining"


def test_gateway_host_tier_stats_equal_jax(ctx):
    """A tier of 64 MiB behind one replica of 8 pages: the pressure of
    the family requests spills and reloads; ``stats()['host_tier']``
    equals the JAX gateway's, per replica and summed."""
    tight = dict(EC, pages_per_shard=8)
    plan_j = jax_make_serve_plan(
        ctx["cfg"], arch=ARCH, n_devices=1, c=1, decode_batch=2,
        page_size=4, max_len=64, mesh_kind="local", prefix_cache=True,
        host_tier_bytes=TIER)
    jgw = jax_gateway.Gateway(ctx["jmodel"], plan_j,
                              JaxEngineConfig(**tight), ctx["params"])
    gw = build_gateway(ARCH, smoke=True, c=1, eng=EngineConfig(**tight),
                       model=ctx["model"], device="cpu", prefix_cache=True,
                       host_tier_bytes=TIER)
    vocab = ctx["cfg"].vocab_size
    got = _drive(gw, _family_requests(vocab, Request, n=8))
    want = _drive(jgw, _family_requests(vocab, JaxRequest, n=8))
    assert got["out"] == want["out"]
    assert got["stats"] == want["stats"]
    tier = got["stats"]["host_tier"]
    assert tier["enabled"] and tier["spill_pages"] > 0, tier
    assert gw.registry.value("gateway_host_tier_hit_rate") == \
        tier["hit_rate"]
    # the replicas' series carry {replica="0"} in the shared registry
    text = gw.registry.render_prometheus()
    assert 'engine_steps_total{replica="0"}' in text
    assert 'kv_transfer_pages_total{op="spill",replica="0"}' in text


def test_gateway_replicas_and_roles_equal_jax(ctx):
    """Two replicas (prefix cache, two sessions) and a prefill/decode pair
    (prefix cache and a host tier) against the JAX gateways of the child
    process, which gives each replica its own host device."""
    vocab = ctx["cfg"].vocab_size
    got = {"replicas": _drive(_torch_gateway(ctx, replicas=2),
                              _family_requests(vocab, Request))}
    roles = _torch_gateway(ctx, roles=["prefill", "decode"],
                           host_tier_bytes=TIER)
    got["roles"] = _drive(roles, _role_requests(vocab, Request),
                          sessions=False)
    stdout, stderr = ctx["child"].communicate(timeout=300)
    assert ctx["child"].returncode == 0, stderr[-4000:]
    want = json.loads(stdout.strip().splitlines()[-1])
    for face in ("replicas", "roles"):
        g, w = got[face], want[face]
        assert g["out"] == w["out"], face
        assert g["owners"] == w["owners"] and g["owner"] == w["owner"], face
        g["stats"]["roles"] = list(g["stats"]["roles"])
        assert g["stats"] == w["stats"], face
        assert _common(g["per"], w["per"]) == w["per"], face
    rep = got["replicas"]["stats"]
    assert rep["routed"] == [3, 3] and rep["affinity_hits"] == 4
    assert all(m["prefill_tokens_cached"] == 32 for m in
               got["replicas"]["per"])
    ro = got["roles"]
    assert ro["owners"] == [0] * 4 and ro["stats"]["handoffs"] == 3
    tier = ro["stats"]["host_tier"]
    assert tier["handoff_out_pages"] == tier["handoff_in_pages"] > 0
    assert ro["per"][1]["prefills"] == 0
    # a unified engine gives the disaggregated streams
    uni = _torch_gateway(ctx)
    for r in _role_requests(vocab, Request):
        uni.add_request(r)
    assert uni.run() == ro["out"]


# ---------------------------------------------------------------------------
# the JAX checks' C = 2 layouts on ThreadMesh ranks
# ---------------------------------------------------------------------------

def _gw(ctx, n, eng=EC, **kw):
    kw.setdefault("prefix_cache", True)
    return build_gateway(ARCH, smoke=True, c=2, n_devices=n,
                         eng=EngineConfig(**eng), model=ctx["model"],
                         device="cpu", **kw)


def test_gateway_prefix_cow_c2(ctx):
    """``check_gateway_prefix_cow``'s layout (C = 2, R = 2: 8 ranks): a
    shared-prefix pair equals its solo cold runs, dropping the whole trie
    under a live sharer corrupts nothing, and a re-arrival misses."""
    eng = dict(EC, pages_per_shard=16)
    gw = _gw(ctx, 8, eng)
    assert gw.engines[0].sp == 8 and gw.plan.c == 2
    assert gw.engines[0].mesh.size == 8
    rng = np.random.default_rng(11)
    vocab = ctx["cfg"].vocab_size
    shared = rng.integers(0, vocab, 16).tolist()
    req_a = Request("a", shared + rng.integers(0, vocab, 5).tolist(), 4,
                    seed=1)
    req_b = Request("b", shared + rng.integers(0, vocab, 7).tolist(), 4,
                    seed=2)
    gw.add_request(req_a)
    gw.step()
    gw.add_request(req_b)
    out = gw.run()
    cache = gw.engines[0].prefix_cache
    assert gw.engines[0].metrics.prefill_tokens_cached == 16
    assert cache.hit_tokens == 16 and cache.hit_rate > 0
    # the port's own engine at the same layout (held against JAX by
    # test_torch_engine_sp.py), cold, each request alone
    solo_eng = Engine(ctx["model"], make_serve_plan(
        registry.get_smoke(ARCH), arch=ARCH, n_devices=8, c=2,
        decode_batch=2, page_size=4, max_len=64), EngineConfig(**eng))
    for r in (req_a, req_b):
        solo_eng.reset()
        solo_eng.add_request(r)
        assert solo_eng.run()[r.uid] == out[r.uid], r.uid
    # drop the trie while B shares its pages
    gw.reset()
    gw.add_request(req_a)
    gw.step()
    gw.add_request(req_b)
    gw.step()
    assert any(s.cached_len for s in gw.engines[0].scheduler.active())
    gw.engines[0].prefix_cache.drop_all()
    assert gw.engines[0].scheduler.pool.pages_in_use() > 0
    assert gw.run() == out
    gw.add_request(Request("a2", req_a.tokens, 4, seed=1))
    pre = gw.engines[0].metrics.prefill_tokens_cached
    assert gw.run()["a2"] == out["a"]
    assert gw.engines[0].metrics.prefill_tokens_cached == pre


def test_gateway_replicas_and_disagg_c2(ctx):
    """``check_gateway_replicas``' and ``check_gateway_disagg``'s layouts:
    two replicas of 4 ranks (C = 2) each, prefix-aware routing, affinity
    and streams equal to solo cold runs pinned to the same replica; then a
    prefill/decode pair of 4 ranks each against a unified gateway of 4."""
    gw = _gw(ctx, 4, replicas=2)
    assert len(gw.engines) == 2 and gw.plan.n_devices == 4
    assert gw.engines[0].mesh is not gw.engines[1].mesh
    rng = np.random.default_rng(5)
    vocab = ctx["cfg"].vocab_size
    shared = rng.integers(0, vocab, 12).tolist()
    reqs = {
        "s0": Request("s0", shared + rng.integers(0, vocab, 3).tolist(), 3,
                      seed=1),
        "s1": Request("s1", shared + rng.integers(0, vocab, 5).tolist(), 3,
                      seed=2),
        "u0": Request("u0", rng.integers(0, vocab, 14).tolist(), 3, seed=3),
        "aff": Request("aff", rng.integers(0, vocab, 9).tolist(), 3, seed=4),
    }
    r0 = gw.add_request(reqs["s0"])
    gw.step()
    assert gw.add_request(reqs["s1"]) == r0
    assert gw.add_request(reqs["u0"]) != r0
    gw.add_request(reqs["aff"], session="sess")
    out = gw.run()
    late = Request("aff2", reqs["aff"].tokens, 3, seed=4)
    assert gw.add_request(late, session="sess") == gw._owner["aff"]
    out.update(gw.run())
    assert out["aff2"] == out["aff"]
    m = gw.metrics_dict()
    assert m["prefix_hit_rate"] > 0 and m["prefill_tokens_cached"] >= 12
    assert m["affinity_hits"] == 1 and sorted(m["routed"])[-1] >= 2
    cold = _gw(ctx, 4, replicas=2, prefix_cache=False)
    for uid, r in reqs.items():
        cold.reset()
        cold.add_request(r, replica=gw._owner[uid])
        assert cold.run()[uid] == out[uid], uid

    dis = _gw(ctx, 4, roles=["prefill", "decode"],
              eng=dict(EC, pages_per_shard=16))
    assert dis.roles == ["prefill", "decode"]
    assert all(p.n_devices == 4 and p.c == 2 for p in dis.plans)
    rng = np.random.default_rng(7)
    dreqs = [
        Request("g", rng.integers(0, vocab, 11).tolist(), 4, seed=1),
        Request("s", rng.integers(0, vocab, 17).tolist(), 5,
                temperature=0.8, top_k=8, top_p=0.9, seed=3),
        Request("one", rng.integers(0, vocab, 5).tolist(), 1, seed=4),
        Request("g2", rng.integers(0, vocab, 6).tolist(), 3, seed=5)]
    assert [dis.add_request(r) for r in dreqs] == [0] * 4
    dout = dis.run()
    assert all(len(dout[r.uid]) == r.max_new_tokens for r in dreqs)
    assert dis.handoffs == 3
    tier = dis.stats()["host_tier"]
    assert tier["handoff_out_pages"] == tier["handoff_in_pages"] > 0
    assert dis.engines[1].metrics.prefills == 0
    assert dis.engines[1].metrics.decode_steps > 0
    uni = _gw(ctx, 4, eng=dict(EC, pages_per_shard=16))
    for r in dreqs:
        uni.add_request(r)
    assert uni.run() == dout
    dis.reset()
    for r in dreqs:
        dis.add_request(r)
    assert dis.run() == dout


# ---------------------------------------------------------------------------
# the serving costs and the role plans
# ---------------------------------------------------------------------------

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


def _same(got, want, where):
    assert sorted(got) == sorted(want), where
    for k, w in want.items():
        g = got[k]
        if isinstance(w, float) and not isinstance(w, bool):
            assert isinstance(g, float), (where, k)
            assert math.isclose(g, w, rel_tol=1e-12, abs_tol=0.0), \
                (where, k, g, w)
        else:
            assert type(g) is type(w) and g == w, (where, k, g, w)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_serving_costs_match_jax(name, monkeypatch):
    monkeypatch.setattr(hw, "HBM_BW", jax_hw.HBM_BW)
    cfg_j = CONFIGS[name]
    cfg = _port_cfg(cfg_j)
    fits = set()
    for sp in (1, 2, 4, 8):
        cl = sch.ClusterModel(sp_size=sp,
                              peak_flops=jax_hw.PEAK_FLOPS_BF16,
                              link_bw=jax_hw.ICI_BW_PER_LINK)
        cl_j = jax_sch.ClusterModel(sp_size=sp)
        for ps in (4, 16):
            for kernel, kernel_j in (("ref", "ref"), ("cuda", "pallas")):
                for batch, cache_len in ((1, 1), (4, 1000), (16, 32768)):
                    _same(cost.decode_step_cost(
                              cfg, batch=batch, cache_len=cache_len, sp=sp,
                              page_size=ps, kernel=kernel, cluster=cl),
                          jax_cost.decode_step_cost(
                              cfg_j, batch=batch, cache_len=cache_len,
                              sp=sp, page_size=ps, kernel=kernel_j,
                              cluster=cl_j),
                          f"{name} decode sp={sp} {kernel} {cache_len}")
                for plen, queued in ((1, 0), (512, 4000), (32768, 10**6)):
                    _same(cost.serve_slo_cost(
                              cfg, prompt_len=plen, queued_tokens=queued,
                              sp=sp, page_size=ps, decode_batch=4,
                              kernel=kernel, cluster=cl),
                          jax_cost.serve_slo_cost(
                              cfg_j, prompt_len=plen, queued_tokens=queued,
                              sp=sp, page_size=ps, decode_batch=4,
                              kernel=kernel_j, cluster=cl_j),
                          f"{name} slo sp={sp} {kernel} {plen}")
            for plen, shared, pages in ((128, 96, 64), (128, 96, 16),
                                        (4096, 1024, 4096), (64, 2, 64)):
                got = cost.prefix_cache_value(
                    cfg, prompt_len=plen, shared_len=shared, requests=8,
                    sp=sp, page_size=ps, pages_per_shard=pages, max_len=32,
                    cluster=cl)
                _same(got, jax_cost.prefix_cache_value(
                    cfg_j, prompt_len=plen, shared_len=shared, requests=8,
                    sp=sp, page_size=ps, pages_per_shard=pages, max_len=32,
                    cluster=cl_j),
                    f"{name} value sp={sp} {plen}/{shared}")
                fits.add(got["fits"])
    assert fits == {True, False}, name
    with pytest.raises(ValueError, match="kernel"):
        cost.decode_step_cost(cfg, batch=1, cache_len=8, sp=1, page_size=4,
                              kernel="pallas")


def test_make_role_plans_match_jax(tmp_path):
    cfg_j = jax_registry.get_smoke(ARCH)
    kw = dict(arch=ARCH, n_devices=4, c=2, decode_batch=2, page_size=4,
              max_len=60, prefix_cache=True, host_tier_bytes=1 << 20)
    want = jax_make_role_plans(cfg_j, roles=["prefill", "decode",
                                             "unified"], mesh_kind="local",
                               replicas=3, role="decode", **kw)
    got = make_role_plans(registry.get_smoke(ARCH),
                          roles=["prefill", "decode", "unified"],
                          replicas=3, role="decode", **kw)
    for g, w in zip(got, want):
        for f in ("role", "replicas", "n_devices", "c", "r", "seq_len",
                  "decode_batch", "page_size", "prefix_cache",
                  "host_tier_bytes", "scheme"):
            assert getattr(g, f) == getattr(w, f), f
    assert [p.role for p in got] == ["prefill", "decode", "unified"]
    with pytest.raises(ValueError, match="roles"):
        make_role_plans(registry.get_smoke(ARCH), roles=[], n_devices=1)
    # the launcher's role-plan file reads back
    from repro_torch.launch import serve

    path = tmp_path / "roles.json"
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--roles",
                "prefill,decode", "--prefix-cache", "--save-plan",
                str(path), "--requests", "2", "--prompt-len", "4", "--gen",
                "2", "--system-prompt-len", "8"])
    rec = json.loads(path.read_text())
    assert [d["role"] for d in rec["plans"]] == ["prefill", "decode"]
    out = serve.main(["--plan", str(path), "--smoke", "--device", "cpu",
                      "--requests", "2", "--prompt-len", "4", "--gen", "2",
                      "--system-prompt-len", "8"])
    assert sorted(out) == ["req0", "req1"]


# ---------------------------------------------------------------------------
# the launcher's gateway mode
# ---------------------------------------------------------------------------

def test_launch_serve_replicas_and_roles(capsys):
    from repro_torch.launch import serve

    base = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "6",
            "--prompt-len", "6", "--gen", "8", "--system-prompt-len", "16",
            "--page-size", "4"]
    two = serve.main(base + ["--replicas", "2", "--prefix-cache"])
    text = capsys.readouterr().out
    assert "replicas=2" in text and "routed=[3, 3]" in text
    assert "affinity_hits=4" in text
    assert "[gateway] analytical cache value/replica:" in text
    assert "[gateway]   replica 1 (unified)" in text
    roles = serve.main(base + ["--roles", "prefill,decode",
                               "--prefix-cache"])
    text = capsys.readouterr().out
    assert "roles=['prefill', 'decode']" in text and "handoffs=6" in text
    one = serve.main(base + ["--prefix-cache"])
    assert two == roles == one
    with pytest.raises(ValueError, match="split evenly"):
        serve.main(base + ["--replicas", "2", "--devices", "3"])
