"""repro_torch's host KV tier against the JAX package's, on the CPU with no
model.

* ``HostTier`` and ``KVConnector`` over a fake pool (the two transfers as
  plain gathers and scatters), the cost-aware prefix-cache eviction that
  feeds the connector, and the scheduler's host-hit admission: the JAX
  package's own tests (``tests/test_kv_connector.py``) on the port.
* The JAX and the port connector driven through one seeded sequence of
  spill, page reuse, flush, has, reload, export, inject and reset over
  equal fake pools, under capacity pressure with a cost gate: every return
  value, ``stats()`` and the pool contents equal after every operation.
* ``prefill_step_cost`` (every field),
  ``kv_bytes_per_token``, ``kv_transfer_cost`` and ``spill_decision``
  against the JAX ones on the 13 configs at SP degree 1-8, under the JAX table's constants (an
  equal explicit ``ClusterModel``, and the port's ``hw`` HBM and host-link
  rates patched to the JAX table's).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.configs import paper_models
from repro.configs import registry as jax_registry
from repro.core import scheduler as jax_sch
from repro.engine import kv_connector as jax_kv
from repro.plan import cost as jax_cost
from repro.roofline import hw as jax_hw

from repro_torch.configs import base as tbase
from repro_torch.configs import registry
from repro_torch.core import scheduler as sch
from repro_torch.engine import Request, Scheduler
from repro_torch.engine.kv_connector import HostTier, KVConnector, _HostPage
from repro_torch.engine.paged_cache import PagePool
from repro_torch.gateway import PrefixCache, block_hashes
from repro_torch.plan import cost
from repro_torch.roofline import hw

ARCH = "h2o-danube-1.8b"
CONFIGS = {**{a: jax_registry.get(a) for a in jax_registry.ASSIGNED_ARCHS},
           "gpt-3b": paper_models.GPT_3B, "gpt-7b": paper_models.GPT_7B,
           "dit-1b": paper_models.DIT_1B}


# ---------------------------------------------------------------------------
# HostTier: committed-page LRU store
# ---------------------------------------------------------------------------

def _hp(key, tokens=4):
    return _HostPage(key=key, chain_tokens=tokens,
                     data={"k": torch.zeros(1)})


def test_host_tier_capacity_lru():
    tier = HostTier(capacity_bytes=2 * 64, page_bytes=64)
    assert tier.capacity_pages == 2
    tier.put(_hp(1))
    tier.put(_hp(2))
    tier.get(1)                          # touch: 1 is now most recent
    dropped = tier.put(_hp(3))           # over capacity: LRU (2) goes
    assert dropped == 1 and tier.evicted_pages == 1
    assert tier.has(1) and tier.has(3) and not tier.has(2)
    assert tier.bytes_resident == 2 * 64


def test_host_tier_has_is_pure():
    tier = HostTier(capacity_bytes=2 * 64, page_bytes=64)
    tier.put(_hp(1))
    tier.put(_hp(2))
    tier.has(1)                          # a probe must not touch LRU order
    assert tier.put(_hp(3)) == 1
    assert not tier.has(1)               # 1 stayed LRU and was evicted


def test_host_tier_put_dedupes():
    tier = HostTier(capacity_bytes=4 * 64, page_bytes=64)
    tier.put(_hp(1))
    assert tier.put(_hp(1)) == 0
    assert len(tier) == 1


def test_host_tier_rejects_bad_page_bytes():
    with pytest.raises(ValueError, match="page_bytes"):
        HostTier(capacity_bytes=64, page_bytes=0)


# ---------------------------------------------------------------------------
# KVConnector against a fake pool
# ---------------------------------------------------------------------------

class _FakePool:
    """Stand-in for the engine's transfers: {'k','v'} tensors (1, pages,
    ps, Hkv, hd); read gathers a bucket, write scatters one back."""

    def __init__(self, n_pages=8, ps=4, hkv=2, hd=3):
        n = n_pages * ps * hkv * hd
        self.pools = {name: (torch.arange(n, dtype=torch.float32) + off)
                      .reshape(1, n_pages, ps, hkv, hd)
                      for name, off in (("k", 0.0), ("v", 0.5))}

    def read(self, idx):
        sel = torch.from_numpy(np.clip(idx, 0, None))
        return {n: t.index_select(1, sel) for n, t in self.pools.items()}

    def write(self, idx, data):
        for j, g in enumerate(np.asarray(idx)):
            if g >= 0:
                for n, t in self.pools.items():
                    t[:, g] = data[n][:, j]

    def page(self, g):
        return {n: t[:, g].clone() for n, t in self.pools.items()}


def _connector(fake, capacity_pages=8, spill_fn=None):
    page_bytes = sum(t[:, 0].numel() * t.element_size()
                     for t in fake.pools.values())
    return KVConnector(read_fn=fake.read, write_fn=fake.write, bucket=2,
                       page_size=4, pages_per_shard=8,
                       page_bytes=page_bytes,
                       capacity_bytes=capacity_pages * page_bytes,
                       spill_fn=spill_fn)


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for n in want:
        assert torch.equal(got[n], want[n]), n


def test_torn_spill_not_hittable_until_flush():
    fake = _FakePool()
    conn = _connector(fake)
    assert conn.spill(key=11, page=(0, 2), chain_tokens=4)
    assert not conn.has(11)              # staged only
    assert conn.stats()["staged_pages"] == 1
    assert conn.flush() == 1
    assert conn.has(11)
    _equal(conn.tier.get(11).data, fake.page(2))
    assert conn.stats()["spill_pages"] == 1


def test_spill_captures_value_before_page_reuse():
    fake = _FakePool()
    conn = _connector(fake)
    snapshot = fake.page(2)
    conn.spill(key=11, page=(0, 2), chain_tokens=4)
    for t in fake.pools.values():
        t[:, 2] = -1.0                   # page recycled before the flush
    conn.flush()
    _equal(conn.tier.get(11).data, snapshot)


def test_spill_dedupe_staged_and_committed():
    fake = _FakePool()
    conn = _connector(fake)
    assert conn.spill(key=11, page=(0, 2), chain_tokens=4)
    assert not conn.spill(key=11, page=(0, 2), chain_tokens=4)  # staged dup
    conn.flush()
    assert not conn.spill(key=11, page=(0, 3), chain_tokens=4)  # committed
    assert conn.stats()["spill_pages"] == 1


def test_spill_fn_gates_only_under_pressure():
    fake = _FakePool()
    gate = {"ok": False}
    conn = _connector(fake, capacity_pages=1,
                      spill_fn=lambda tokens: gate["ok"])
    # free capacity always admits, even with a refusing cost model
    assert conn.spill(key=1, page=(0, 0), chain_tokens=4)
    conn.flush()
    # at capacity the cost model decides
    assert not conn.spill(key=2, page=(0, 1), chain_tokens=4)
    assert conn.stats()["spills_skipped"] == 1
    gate["ok"] = True
    assert conn.spill(key=3, page=(0, 2), chain_tokens=8)
    conn.flush()                         # displaces the LRU committed page
    assert conn.stats()["host_evicted_pages"] == 1
    assert conn.has(3) and not conn.has(1)


def test_disabled_connector_never_spills():
    conn = _connector(_FakePool(), capacity_pages=0)
    assert not conn.enabled
    assert not conn.spill(key=1, page=(0, 0), chain_tokens=4)


def test_reload_roundtrip_and_missing_key():
    fake = _FakePool()
    conn = _connector(fake)
    want = {11: fake.page(1), 12: fake.page(2), 13: fake.page(3)}
    for key, page in ((11, 1), (12, 2), (13, 3)):
        conn.spill(key=key, page=(0, page), chain_tokens=4)
    conn.flush()
    for t in fake.pools.values():
        t.zero_()                        # device pages recycled
    # reload into fresh pages 5, 6, 7: two transfer buckets
    conn.reload([(11, (0, 5)), (12, (0, 6)), (13, (0, 7))])
    for key, page in ((11, 5), (12, 6), (13, 7)):
        _equal(fake.page(page), want[key])
    assert conn.stats()["reload_pages"] == 3
    assert conn.has(11)                  # entries stay resident
    with pytest.raises(RuntimeError, match="missing chain hash"):
        conn.reload([(999, (0, 4))])


def test_export_inject_handoff_between_pools():
    src, dst = _FakePool(), _FakePool()
    for t in dst.pools.values():
        t.zero_()
    a = _connector(src, capacity_pages=0)     # handoff works with tier off
    b = _connector(dst, capacity_pages=0)
    blocks = a.export([(0, 1), (0, 2), (0, 3)])
    assert len(blocks) == 3
    b.inject([(0, 4), (0, 5), (0, 6)], blocks)
    for s, d in ((1, 4), (2, 5), (3, 6)):
        _equal(dst.page(d), src.page(s))
    assert a.stats()["handoff_out_pages"] == 3
    assert b.stats()["handoff_in_pages"] == 3
    with pytest.raises(ValueError, match="blocks"):
        b.inject([(0, 4)], blocks)


def test_connector_reset_drops_everything():
    fake = _FakePool()
    conn = _connector(fake)
    conn.spill(key=1, page=(0, 0), chain_tokens=4)
    conn.flush()
    conn.spill(key=2, page=(0, 1), chain_tokens=4)   # left staged
    conn.note_probe(2, 1)
    conn.reset()
    s = conn.stats()
    assert s["resident_pages"] == 0 and s["staged_pages"] == 0
    assert s["spill_pages"] == 0 and s["hit_tokens"] == 0
    assert conn.hit_rate == 0.0


# ---------------------------------------------------------------------------
# The JAX connector and the port's through one seeded sequence
# ---------------------------------------------------------------------------

class _NumpyPool:
    """The JAX test's fake pool over {'k','v'} numpy arrays."""

    def __init__(self, fake: _FakePool):
        self.pools = {n: t.numpy().copy() for n, t in fake.pools.items()}

    def read(self, idx):
        return {n: a[:, np.clip(idx, 0, None)].copy()
                for n, a in self.pools.items()}

    def write(self, idx, data):
        for j, g in enumerate(np.asarray(idx)):
            if g >= 0:
                for n, a in self.pools.items():
                    a[:, g] = data[n][:, j]


def _same_page(got, want):
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))


def test_connector_sequence_matches_jax():
    rng = np.random.default_rng(3)
    fake = _FakePool(n_pages=8)
    jfake = _NumpyPool(fake)
    page_bytes = sum(t[:, 0].numel() * t.element_size()
                     for t in fake.pools.values())
    # 3 pages of capacity and a cost gate: LRU evictions and skipped spills
    kw = dict(bucket=2, page_size=4, pages_per_shard=4,
              page_bytes=page_bytes, capacity_bytes=3 * page_bytes,
              spill_fn=lambda tokens: tokens >= 8)
    conn = KVConnector(read_fn=fake.read, write_fn=fake.write, **kw)
    jconn = jax_kv.KVConnector(read_fn=jfake.read, write_fn=jfake.write,
                               **kw)
    keys = [101, 102, 103, 104, 105, 106]
    ops = {"spill": 0, "reuse": 0, "flush": 0, "reload": 0, "export": 0,
           "inject": 0, "probe": 0, "reset": 0}
    for i in range(160):
        op = rng.choice(["spill", "spill", "spill", "reuse", "flush",
                         "flush", "reload", "export", "inject", "probe",
                         "reset"], p=[.15, .15, .1, .1, .1, .1, .1, .04,
                                      .04, .06, .06])
        ops[str(op)] += 1
        page = (int(rng.integers(0, 2)), int(rng.integers(0, 4)))
        if op == "spill":
            kwargs = dict(key=int(rng.choice(keys)), page=page,
                          chain_tokens=4 * int(rng.integers(1, 4)))
            assert conn.spill(**kwargs) == jconn.spill(**kwargs)
        elif op == "reuse":                  # a page rewritten in place
            g = conn.global_id(page)
            val = float(rng.normal())
            for n in fake.pools:
                fake.pools[n][:, g] = val
                jfake.pools[n][:, g] = val
        elif op == "flush":
            assert conn.flush() == jconn.flush()
        elif op == "reload":
            have = [k for k in keys if jconn.has(k)]
            assert [k for k in keys if conn.has(k)] == have
            if have:
                n = int(rng.integers(1, len(have) + 1))
                items = [(k, (int(rng.integers(0, 2)), j))
                         for j, k in enumerate(have[:n])]
                conn.reload(items)
                jconn.reload(items)
        elif op in ("export", "inject"):
            pages = [(int(rng.integers(0, 2)), int(rng.integers(0, 4)))
                     for _ in range(int(rng.integers(1, 4)))]
            got, want = conn.export(pages), jconn.export(pages)
            assert len(got) == len(want) == len(pages)
            for g, w in zip(got, want):
                _same_page(g, w)
            if op == "inject":               # back into other pages
                dst = [(1 - s, (p + 1) % 4) for s, p in pages]
                conn.inject(dst, got)
                jconn.inject(dst, want)
        elif op == "probe":
            lookup = int(rng.integers(1, 5))
            hit = int(rng.integers(0, lookup + 1))
            conn.note_probe(lookup, hit)
            jconn.note_probe(lookup, hit)
        else:
            conn.reset()
            jconn.reset()
        assert conn.stats() == jconn.stats(), (i, op)
        for n in fake.pools:
            np.testing.assert_array_equal(fake.pools[n].numpy(),
                                          jfake.pools[n], err_msg=f"{i} {op}")
    assert all(ops.values()), ops
    # the sequence reached pressure: LRU evictions and refused spills
    conn.reset()
    jconn.reset()
    for j, k in enumerate(keys):
        assert conn.spill(key=k, page=(0, j % 4), chain_tokens=4 + 4 * (j % 2)
                          ) == jconn.spill(key=k, page=(0, j % 4),
                                           chain_tokens=4 + 4 * (j % 2))
        assert conn.flush() == jconn.flush()
    s = conn.stats()
    assert s == jconn.stats()
    assert s["host_evicted_pages"] > 0 and s["spills_skipped"] > 0


# ---------------------------------------------------------------------------
# Cost-aware prefix-cache eviction
# ---------------------------------------------------------------------------

def _insert_chain(cache, pool, tokens):
    hashes = block_hashes(tokens, cache.page_size)
    pages = [(b % cache.sp, pool.alloc(b % cache.sp))
             for b in range(len(hashes))]
    cache.insert(hashes, pages)
    for s, p in pages:
        pool.decref(s, p)                # cache-only holds remain
    return hashes


def _match_len(cache, hashes):
    return len(cache.match(hashes))


@pytest.mark.parametrize("cost_fn", [None, lambda t: float(t) ** 2],
                         ids=["tokens", "quadratic"])
def test_evict_cheap_shallow_before_expensive_deep(cost_fn):
    pool = PagePool(sp=1, pages_per_shard=8)
    cache = PrefixCache(pool, page_size=4, sp=1, cost_fn=cost_fn)
    deep = _insert_chain(cache, pool, list(range(12)))       # 3 blocks, old
    shallow = _insert_chain(cache, pool, [100, 101, 102, 103])  # 1, recent
    assert cache.evict(0, 1) == 1
    # the recent but cheap chain went; the deep expensive one survived
    assert _match_len(cache, shallow) == 0
    assert _match_len(cache, deep) == 3


def test_evict_lru_breaks_cost_ties():
    pool = PagePool(sp=1, pages_per_shard=8)
    cache = PrefixCache(pool, page_size=4, sp=1)
    old = _insert_chain(cache, pool, [1, 2, 3, 4])
    new = _insert_chain(cache, pool, [5, 6, 7, 8])
    cache.evict(0, 1)
    assert _match_len(cache, old) == 0 and _match_len(cache, new) == 1


def test_evict_offers_victim_to_connector_before_drop():
    pool = PagePool(sp=1, pages_per_shard=8)
    calls = []

    class _Rec:
        def spill(self, *, key, page, chain_tokens):
            # the pool page must still be held when the spill is staged
            calls.append((key, tuple(page), chain_tokens,
                          pool.refs[tuple(page)]))
            return True

    cache = PrefixCache(pool, page_size=4, sp=1, connector=_Rec())
    hashes = _insert_chain(cache, pool, list(range(8)))
    cache.evict(0, 2)
    assert [(c[0], c[2]) for c in calls] == \
        [(hashes[1], 8), (hashes[0], 4)]          # leaf-first, chain depth
    assert all(c[3] == 1 for c in calls)          # spilled before release


# ---------------------------------------------------------------------------
# Scheduler admission with host-tier hits
# ---------------------------------------------------------------------------

class _StubConnector:
    enabled = True

    def __init__(self, keys):
        self.keys = set(keys)
        self.probes = []

    def has(self, key):
        return key in self.keys

    def note_probe(self, lookup_blocks, hit_blocks):
        self.probes.append((lookup_blocks, hit_blocks))


def test_admit_counts_host_hits_and_records_reloads():
    sched = Scheduler(max_slots=2, page_size=4, sp=1, pages_per_shard=8,
                      max_len=64)
    sched.prefix_cache = PrefixCache(sched.pool, page_size=4, sp=1)
    tokens = list(range(13))             # 3 full blocks + tail, usable=3
    hashes = block_hashes(tokens, 4)
    conn = _StubConnector(hashes[:2])    # blocks 0, 1 live on the host
    sched.connector = conn
    sched.enqueue(Request("r", tokens, 2))
    st, = sched.admit(0)
    assert st.cached_len == 8 and st.host_len == 8
    assert st.prefill_pos == 8           # suffix prefill starts past hits
    # host hits still take fresh pool pages (cheap, not free)
    assert len(st.pages) == 4 and sched.pool.pages_in_use() == 4
    assert [h for h, _ in st.pending_reload] == hashes[:2]
    assert [p for _, p in st.pending_reload] == st.pages[:2]
    assert conn.probes == [(3, 2)]


def test_blocked_admission_is_side_effect_free_with_host_hits():
    sched = Scheduler(max_slots=2, page_size=4, sp=1, pages_per_shard=4,
                      max_len=64)
    sched.prefix_cache = PrefixCache(sched.pool, page_size=4, sp=1)
    for _ in range(2):                   # live sequences pin half the pool
        sched.pool.alloc(0)
    tokens = list(range(13))             # needs 4 pages; only 2 are free
    conn = _StubConnector(block_hashes(tokens, 4))
    sched.connector = conn
    sched.enqueue(Request("r", tokens, 2))
    assert sched.admit(0) == []
    assert conn.probes == []             # no hit-rate skew
    assert sched.pool.pages_in_use() == 2
    assert len(sched.queue) == 1


# ---------------------------------------------------------------------------
# Spill-vs-recompute pricing (plan.cost)
# ---------------------------------------------------------------------------

def _cfg():
    return registry.get_smoke(ARCH)


def test_spill_decision_fields_and_validation():
    cfg = _cfg()
    d = cost.spill_decision(cfg, chain_tokens=64, page_size=4)
    assert d["bytes"] == 64 * cost.kv_bytes_per_token(cfg)
    assert d["spill"] == (d["transfer_s"] < d["recompute_s"])
    with pytest.raises(ValueError, match="chain_tokens"):
        cost.spill_decision(cfg, chain_tokens=0)
    with pytest.raises(ValueError, match="cached_len"):
        cost.prefill_step_cost(cfg, prompt_len=8, cached_len=9)


def test_spill_decision_monotone_in_chain_and_link():
    # recompute grows quadratically in the chain, the round trip linearly:
    # once a chain spills every longer one does, and a faster link only
    # moves the crossover down
    cfg = _cfg()
    ps, blocks = 4, range(1, 257)
    firsts = []
    for link_bw in (1e6, 1e9, 1e12, 1e15):
        flags = [cost.spill_decision(cfg, chain_tokens=b * ps, page_size=ps,
                                     link_bw=link_bw)["spill"]
                 for b in blocks]
        assert flags == sorted(flags), f"link_bw={link_bw}"
        firsts.append(flags.index(True) if True in flags else len(flags))
    assert firsts == sorted(firsts, reverse=True)
    assert firsts[0] > firsts[-1]


def test_transfer_cost_linear_not_sp_divided():
    cfg = _cfg()
    a = cost.kv_transfer_cost(cfg, tokens=100)
    b = cost.kv_transfer_cost(cfg, tokens=200)
    assert b["bytes"] == 2 * a["bytes"]
    assert b["roundtrip_s"] == pytest.approx(2 * a["roundtrip_s"])
    assert a["roundtrip_s"] == pytest.approx(a["d2h_s"] + a["h2d_s"])
    # the card's host link: PCIe Gen5 x16, 64e9 B/s each way
    assert a["d2h_s"] == a["bytes"] / hw.HOST_LINK_BW == a["bytes"] / 64e9


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
def test_host_tier_costs_match_jax(name, monkeypatch):
    # the JAX table's rates in the port (the cluster is passed explicitly)
    monkeypatch.setattr(hw, "HBM_BW", jax_hw.HBM_BW)
    monkeypatch.setattr(hw, "HOST_LINK_BW", jax_hw.HOST_LINK_BW)
    cfg_j = CONFIGS[name]
    cfg = _port_cfg(cfg_j)
    assert cost.kv_bytes_per_token(cfg) == jax_cost.kv_bytes_per_token(cfg_j)
    flips = set()
    for sp in (1, 2, 4, 8):
        cl = sch.ClusterModel(sp_size=sp,
                              peak_flops=jax_hw.PEAK_FLOPS_BF16,
                              link_bw=jax_hw.ICI_BW_PER_LINK)
        cl_j = jax_sch.ClusterModel(sp_size=sp)
        for ps in (4, 16):
            for tokens in (16, 1024, 32768):
                for cached in (0, tokens // 4, tokens):
                    want = jax_cost.prefill_step_cost(
                        cfg_j, prompt_len=tokens, cached_len=cached, sp=sp,
                        page_size=ps, cluster=cl_j)
                    _same(cost.prefill_step_cost(
                              cfg, prompt_len=tokens, cached_len=cached,
                              sp=sp, page_size=ps, cluster=cl),
                          want,
                          f"{name} prefill sp={sp} {tokens}/{cached}")
                _same(cost.kv_transfer_cost(cfg, tokens=tokens),
                      jax_cost.kv_transfer_cost(cfg_j, tokens=tokens),
                      f"{name} transfer {tokens}")
                for bw in (None, 1e9):
                    got = cost.spill_decision(
                        cfg, chain_tokens=tokens, sp=sp, page_size=ps,
                        link_bw=bw, cluster=cl)
                    _same(got, jax_cost.spill_decision(
                        cfg_j, chain_tokens=tokens, sp=sp, page_size=ps,
                        link_bw=bw, cluster=cl_j),
                        f"{name} spill sp={sp} {tokens}")
                    flips.add(got["spill"])
    assert flips == {True, False}, name
