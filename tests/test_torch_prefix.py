"""repro_torch's prefix-cached and chunked prefill vs the JAX package.

* The plain version of kernel B6 (``kernels.paged_prefill``) against the
  Pallas ``paged_prefill_attention`` in interpret mode and against the JAX
  ``dispatch.paged_prefill(impl='ref')``: 2e-5 in f32 on live rows, dead
  rows exactly o = 0, lse = -1e30.
* ``gateway.PrefixCache`` against the JAX cache on one scripted sequence
  of insert / match / acquire / evict: the same hashes, matches, counts,
  evictions and stats.
* ``serve.step.lm_prefill_paged`` against the JAX one (smoke
  h2o-danube-1.8b, f32, one CPU device): the next-token hidden state within
  2e-5 and the suffix pages written alike.
* The engine with the prefix cache and chunked prefill on and off: every
  configuration gives the greedy tokens of the JAX engine's monolithic
  prefill on the same weights (the JAX *chunked* path is no oracle here:
  its own schedule test fails on this jax), and the port's
  ``prefill_tokens_cached`` equals the JAX prefix-cached engine's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import engine as jax_engine
from repro.configs import registry as jax_registry
from repro.dist.sharding import SP_AXES
from repro.engine import paged_cache as jax_paged_cache
from repro.engine.scheduler import bucket_pow2
from repro.gateway import prefix_cache as jax_prefix
from repro.kernels import dispatch as jax_dispatch
from repro.kernels import paged_prefill as jax_paged_prefill
from repro.plan import make_serve_plan as jax_make_serve_plan
from repro.serve import step as jax_serve_step
from repro_torch import engine as torch_engine
from repro_torch.engine import paged_cache
from repro_torch.gateway import prefix_cache
from repro_torch.kernels import paged_prefill
from repro_torch.models.factory import from_jax_params
from repro_torch.plan import make_serve_plan
from repro_torch.serve import step as serve_step
from test_torch_gpu import (PAGED_PREFILL_CASES, _assert_partials,
                            _paged_prefill_inputs, _t)

ARCH = "h2o-danube-1.8b"
ENG = dict(max_slots=2, page_size=4, pages_per_shard=32, max_len=64)
_CTX = {}


@pytest.mark.parametrize("case", sorted(PAGED_PREFILL_CASES))
def test_paged_prefill_plain_matches_jax(case):
    B, Sq, Hq, Hkv, D, ps, W, sp, rank, window, cls = \
        PAGED_PREFILL_CASES[case]
    arrs = _paged_prefill_inputs(B, Sq, Hq, Hkv, D, ps, W, sp, rank, cls)
    kw = dict(sp=sp, page_size=ps, window=window)
    o_j, lse_j = jax_paged_prefill.paged_prefill_attention(
        *(jnp.asarray(x) for x in arrs), jnp.int32(rank), interpret=True,
        **kw)
    o_r, lse_r = jax_dispatch.paged_prefill(
        *(jnp.asarray(x) for x in arrs), jnp.int32(rank), impl="ref", **kw)
    paged_prefill.reset_launches()
    o_t, lse_t = paged_prefill.paged_prefill_attention(
        *(_t(x) for x in arrs), rank, **kw)
    # CPU tensors run the plain version: no kernel launch is counted
    assert paged_prefill.LAUNCHES == {"B6": 0}
    _assert_partials(o_t.numpy(), lse_t.numpy(), o_j, lse_j)
    _assert_partials(o_t.numpy(), lse_t.numpy(), o_r, lse_r)
    dead = lse_t.numpy() <= -1e30 / 2
    if 0 in cls:
        # a row with nothing cached is dead on every head and query
        assert dead[list(cls).index(0)].all()
    if window is not None:
        assert dead.any() and not dead.all()


def _script(pkg, pool_cls):
    """One scripted run of a prefix cache over a 2-shard pool, returning
    everything it observed."""
    ps, sp = 4, 2
    pool = pool_cls(sp, 6)
    cache = pkg.PrefixCache(pool, page_size=ps, sp=sp)
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 100, 12).tolist()
    a = shared + rng.integers(0, 100, 6).tolist()
    b = shared + rng.integers(0, 100, 9).tolist()
    seen = {"hashes": [pkg.block_hashes(a, ps), cache.hashes(b)]}

    def alloc(n):
        return [(i % sp, pool.alloc(i % sp)) for i in range(n)]

    pages_a = alloc(4)
    seen["insert_a"] = cache.insert(seen["hashes"][0], pages_a)
    seen["match_b"] = cache.match(seen["hashes"][1])
    seen["evictable"] = cache.evictable_counts(sp)
    seen["evictable_ex"] = cache.evictable_counts(sp,
                                                  exclude=seen["match_b"])
    seen["acquire_b"] = cache.acquire(seen["hashes"][1])
    pages_b = seen["acquire_b"] + [(i % sp, pool.alloc(i % sp))
                                   for i in range(3, 5)]
    seen["insert_b"] = cache.insert(seen["hashes"][1], pages_b)
    for shard, page in pages_a:                      # request a finishes
        pool.decref(shard, page)
    seen["evict_0"] = cache.evict(0, 2)
    seen["refs"] = pool.refs.tolist()
    for shard, page in pages_b:                      # request b finishes
        pool.decref(shard, page)
    seen["evict_1"] = cache.evict(1, 5)
    seen["stats"] = cache.stats()
    seen["free"] = [sorted(f) for f in pool.free]
    return seen


def test_prefix_cache_matches_jax_script():
    got = _script(prefix_cache, paged_cache.PagePool)
    want = _script(jax_prefix, jax_paged_cache.PagePool)
    assert got == want
    # a's own leaf (shard 1) goes first though shard 0 asked: b still holds
    # the shared chain, so nothing on shard 0 is evictable yet
    assert got["match_b"] and got["evict_0"] == 0 and got["evict_1"] > 0
    assert got["stats"]["evicted_pages"] > got["evict_1"]


def _shared_prefix_requests(vocab, cls):
    """Three prompts sharing a 12-token (three-page) prefix, with suffixes
    of their own, and one unrelated prompt."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, 12).tolist()
    return [cls("a", shared + rng.integers(0, vocab, 5).tolist(), 4),
            cls("b", shared + rng.integers(0, vocab, 9).tolist(), 5),
            cls("c", rng.integers(0, vocab, 7).tolist(), 3),
            cls("d", shared + rng.integers(0, vocab, 2).tolist(), 4)]


def _jax_engine(prefix):
    cfg = jax_registry.get_smoke(ARCH)
    plan = jax_make_serve_plan(
        cfg, arch=ARCH, n_devices=1, c=1, decode_batch=ENG["max_slots"],
        page_size=ENG["page_size"], max_len=ENG["max_len"],
        prefix_cache=prefix)
    return jax_engine.build_engine(
        ARCH, smoke=True, eng=jax_engine.EngineConfig(**ENG), plan=plan)


def _torch_engine(model, prefix, chunk):
    cfg = model.cfg
    plan = make_serve_plan(cfg, arch=ARCH, c=1,
                           decode_batch=ENG["max_slots"],
                           page_size=ENG["page_size"],
                           max_len=ENG["max_len"], prefix_cache=prefix)
    return torch_engine.Engine(model, plan, torch_engine.EngineConfig(
        **ENG, prefill_chunk=chunk))


def _ctx():
    if not _CTX:
        jeng = _jax_engine(prefix=False)
        jeng_pc = _jax_engine(prefix=True)
        cfg = jeng.cfg
        reqs = _shared_prefix_requests(cfg.vocab_size, jax_engine.Request)
        for r in reqs:
            jeng.add_request(r)
        want = jeng.run()
        for r in _shared_prefix_requests(cfg.vocab_size, jax_engine.Request):
            jeng_pc.add_request(r)
        assert jeng_pc.run() == want
        model = from_jax_params(jax.tree.map(np.asarray, jeng.params), cfg,
                                "cpu")
        _CTX.update(cfg=cfg, jeng=jeng, model=model, want=want,
                    jax_cached=jeng_pc.metrics.prefill_tokens_cached)
    return _CTX


@pytest.mark.parametrize("prefix,chunk", [(False, 0), (True, 0),
                                          (False, 8), (True, 8)],
                         ids=["monolithic", "prefix", "chunked",
                              "prefix_chunked"])
def test_engine_streams_match_jax_monolithic(prefix, chunk):
    ctx = _ctx()
    teng = _torch_engine(ctx["model"], prefix, chunk)
    for r in _shared_prefix_requests(ctx["cfg"].vocab_size,
                                     torch_engine.Request):
        assert teng.add_request(r) is None
    assert teng.run() == ctx["want"]
    m = teng.metrics
    prompt = sum(len(r.tokens) for r in _shared_prefix_requests(
        ctx["cfg"].vocab_size, torch_engine.Request))
    assert m.prefill_tokens_computed + m.prefill_tokens_cached == prompt
    if chunk:
        assert m.prefill_chunks > m.prefills
    if prefix and not chunk:
        assert m.prefill_tokens_cached == ctx["jax_cached"] > 0
    if prefix:
        assert m.prefill_tokens_cached > 0
        assert m.to_dict()["prefix_hit_rate"] > 0
        assert teng.prefix_cache.stats()["resident_pages"] > 0
    else:
        assert m.prefill_tokens_cached == 0


def test_lm_prefill_paged_matches_jax():
    """One suffix prefill over a random pool: the hidden state of the last
    prompt position and the suffix pages it writes."""
    ctx = _ctx()
    cfg, jeng, model = ctx["cfg"], ctx["jeng"], ctx["model"]
    ps, W, pages = ENG["page_size"], 16, ENG["pages_per_shard"]
    cached, suffix = 8, 6
    prompt_len = cached + suffix
    rng = np.random.default_rng(5)
    shape = (cfg.num_layers, pages, ps, cfg.num_kv_heads, cfg.head_dim_)
    pool = {n: rng.normal(size=shape).astype(np.float32) for n in "kv"}
    table = np.full((1, W), -1, np.int32)
    table[0, :4] = rng.permutation(pages)[:4]
    tokens = rng.integers(0, cfg.vocab_size, suffix)

    bucket = bucket_pow2(suffix, ps)
    rt = dataclasses.replace(jeng.rt, st_cfg=dataclasses.replace(
        jeng.rt.st_cfg, seq_len=bucket))
    part = jax_paged_cache.pool_partition(cfg)
    fn = jax.jit(jax.shard_map(
        lambda params, toks, pl, cl, pools, tbl: jax_serve_step
        .lm_prefill_paged(rt, params, {"tokens": toks}, cfg, prompt_len=pl,
                          cached_len=cl, pools=pools, table_row=tbl,
                          page_size=ps),
        mesh=jeng.mesh, in_specs=(jeng._param_specs, P(None, SP_AXES), P(),
                                  P(), part, P()),
        out_specs=(P(), part), check_vma=False))
    buf = np.zeros((1, bucket), np.int32)
    buf[0, :suffix] = tokens
    want, want_pools = fn(jeng.params, buf,
                          np.asarray([prompt_len], np.int32),
                          np.asarray([cached], np.int32),
                          {"stack": {"sub0": {n: pool[n] for n in "kv"}}},
                          table)

    pools = {n: torch.from_numpy(pool[n].copy()) for n in "kv"}
    rt_t = torch_engine.build_engine(
        ARCH, smoke=True, eng=torch_engine.EngineConfig(**ENG), model=model,
        device="cpu").rt
    with torch.no_grad():
        got = serve_step.lm_prefill_paged(
            rt_t, model, torch.from_numpy(tokens[None]), cfg,
            prompt_len=prompt_len, cached_len=cached, pools=pools,
            table_row=table, page_size=ps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    # every slot but the last page's two past the prompt, which hold the
    # JAX bucket's padding (zeros here) and are never read
    valid = np.ones(shape[1:3], bool)
    valid[table[0, 3], prompt_len % ps:] = False
    for n in "kv":
        np.testing.assert_allclose(
            pools[n].numpy()[:, valid],
            np.asarray(want_pools["stack"]["sub0"][n])[:, valid],
            atol=2e-5, rtol=2e-5)
    # the two suffix blocks landed in table entries 2 and 3 only
    touched = np.nonzero((pools["k"].numpy() != pool["k"]).any(
        axis=(0, 2, 3, 4)))[0]
    assert sorted(touched) == sorted(table[0, 2:4])
