"""repro_torch's sampled decoding vs the JAX package.

* ``engine.sampling.sample`` fed JAX's own gumbel noise (the draw JAX's
  local mode makes, ``gumbel(fold_in(key, 0), (V,))``) returns JAX's token
  on the ``tests/test_engine.py`` fixture (V = 64) and on a V = 1000 table
  whose last 10 rows are padding with the largest logits, for every cell of
  temperature {0, 0.7, 1.3} x top-k {0, 1, 8, 64, 100} x top-p {1.0, 0.9,
  0.4, 0.05}, four keys each, as one batch of rows. At P = 2 and 4 on a
  ``ThreadMesh`` each rank gets its vocab slice of the same noise; there
  ``max_top_k`` is 128 on both sides, so no rank's candidate cap binds and
  the top-k threshold is the same as one rank's (JAX's local mode has one).
* The port's own generator: ports of ``test_top_k_membership_and_
  determinism``, ``test_top_p_membership`` and ``test_zero_temperature_
  rows_are_greedy``; its keys are a pure function of (seed, position,
  rank).
* The engine at c = 2 (``ThreadMesh(2, 1)``, P = 4) on smoke h2o with
  ``check_engine_mixed``'s 8 requests (even greedy, odd sampled, one
  arrival per step): a replay gives the same streams, each sampled request
  alone gives its stream, and the greedy rows equal the JAX engine's
  streams of an all-greedy batch on the same weights.
* A sampled stream is unchanged by ``prefill_chunk=8`` and by a prefix-cache
  hit, which shows the first token's key folds ``prompt_len``.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jax_engine
from repro.configs import registry as jax_registry
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core.startrail import StarTrailConfig as JaxStarTrailConfig
from repro.engine import sampling as jax_sampling
from repro.models.runtime import Runtime as JaxRuntime
from repro.plan import make_serve_plan as jax_make_serve_plan
from repro_torch import engine as torch_engine
from repro_torch.configs.base import ModelConfig
from repro_torch.core.startrail import StarTrailConfig
from repro_torch.dist.comm import SingleComm, ThreadMesh
from repro_torch.engine import sampling
from repro_torch.models.factory import from_jax_params
from repro_torch.models.runtime import Runtime
from repro_torch.plan import make_serve_plan

TEMPS = (0.0, 0.7, 1.3)
TOP_KS = (0, 1, 8, 64, 100)
TOP_PS = (1.0, 0.9, 0.4, 0.05)
KEYS_PER_CELL = 4
MESHES = {1: None, 2: (1, 2), 4: (2, 1)}
_CTX = {}


def _fixture(kind):
    """(vocab_size, table (V, 4) f32, x (1, 1, 4) f32, logits (V,)):
    ``logits_v == table[v, 0]``."""
    if kind == "v64":       # tests/test_engine.py's fixture
        rng = np.random.default_rng(0)
        vocab, rows = 64, 64
        col = rng.normal(size=rows).astype(np.float32)
    else:                   # 990 tokens in a 1000-row table
        rng = np.random.default_rng(1)
        vocab, rows = 990, 1000
        col = (2.0 * rng.normal(size=rows)).astype(np.float32)
        col[vocab:] = 50.0   # padding rows would win every draw if kept
    table = np.zeros((rows, 4), np.float32)
    table[:, 0] = col
    x = np.zeros((1, 1, 4), np.float32)
    x[0, 0, 0] = 1.0
    return vocab, table, x, col


def _grid():
    """(B,) temperature, top_k, top_p and (B, 2) JAX keys: every grid cell
    KEYS_PER_CELL times, each with its own key."""
    cells = [(t, k, p) for t in TEMPS for k in TOP_KS for p in TOP_PS
             for _ in range(KEYS_PER_CELL)]
    temp, top_k, top_p = (np.asarray(c, dt) for c, dt in zip(
        zip(*cells), (np.float32, np.int32, np.float32)))
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(7), i))(
        jnp.arange(len(cells)))
    return temp, top_k, top_p, keys


def _jax_rt():
    return JaxRuntime(mode="local", st_cfg=JaxStarTrailConfig(
        seq_len=8, seq_scheme="contiguous"))


def _torch_rt(comm):
    return Runtime(comm=comm, st_cfg=StarTrailConfig(
        seq_len=8, seq_scheme="contiguous"))


def _cfg(cls, vocab):
    return cls(name="s", family="dense", num_layers=1, d_model=4,
               num_heads=1, num_kv_heads=1, d_ff=8, vocab_size=vocab)


@pytest.mark.parametrize("P", sorted(MESHES))
@pytest.mark.parametrize("kind", ["v64", "v1000_padded"])
def test_sample_matches_jax_given_its_noise(kind, P):
    vocab, table, x, _ = _fixture(kind)
    temp, top_k, top_p, keys = _grid()
    B, V = len(temp), table.shape[0]
    xb = np.repeat(x, B, axis=0)
    jax_sc = jax_sampling.SamplingConfig()
    assert (sampling.MAX_TOP_K, sampling.NUCLEUS_ITERS) == \
        (jax_sc.max_top_k, jax_sc.nucleus_iters)
    max_top_k = sampling.MAX_TOP_K if P == 1 else 128
    want = np.asarray(jax_sampling.sample(
        _jax_rt(), {"table": jnp.asarray(table)}, jnp.asarray(xb),
        _cfg(JaxModelConfig, vocab), temperature=jnp.asarray(temp),
        top_k=jnp.asarray(top_k), top_p=jnp.asarray(top_p), keys=keys,
        sc=jax_sampling.SamplingConfig(max_top_k=max_top_k)))[:, 0]
    # the draw JAX's local mode makes (rank 0)
    noise = np.asarray(jax.vmap(lambda k: jax.random.gumbel(
        jax.random.fold_in(k, 0), (V,), jnp.float32))(keys))
    cfg = _cfg(ModelConfig, vocab)

    def run(comm):
        rt = _torch_rt(comm)
        v_loc = V // rt.sp_size()
        lo = rt.sp_rank() * v_loc
        # the rank's stored vocab rows
        head = types.SimpleNamespace(
            table=torch.from_numpy(table)[lo:lo + v_loc])
        return sampling.sample(
            rt, head, torch.from_numpy(xb), cfg,
            temperature=torch.from_numpy(temp),
            top_k=torch.from_numpy(top_k), top_p=torch.from_numpy(top_p),
            noise=torch.from_numpy(noise[:, lo:lo + v_loc].copy()),
            max_top_k=max_top_k)[:, 0].numpy()

    outs = ([run(SingleComm())] if P == 1
            else ThreadMesh(*MESHES[P]).run(run, timeout=120))
    for got in outs:
        np.testing.assert_array_equal(got, want)
    assert (want < vocab).all()
    greedy = temp <= 0.0
    assert (want[greedy] == np.argmax(table[:vocab, 0])).all()
    assert len(set(want[~greedy].tolist())) > 1


def _draw(temp, top_k, top_p, position, seed=0):
    """One token from the V = 64 fixture with the port's own noise, keyed
    by (seed, position)."""
    vocab, table, x, _ = _fixture("v64")
    key = sampling.fold_in(sampling.seed_key(seed), position)
    tok = sampling.sample(
        _torch_rt(SingleComm()),
        types.SimpleNamespace(table=torch.from_numpy(table)),
        torch.from_numpy(x), _cfg(ModelConfig, vocab),
        temperature=torch.full((1,), temp), top_k=torch.full((1,), top_k),
        top_p=torch.full((1,), top_p), keys=[key])
    return int(tok[0, 0])


def test_top_k_membership_and_determinism():
    full = _fixture("v64")[3]
    allowed = set(np.argsort(full)[-8:].tolist())
    seen = {_draw(1.0, 8, 1.0, i) for i in range(24)}
    assert seen <= allowed
    assert len(seen) > 1
    assert _draw(0.9, 8, 0.9, 5) == _draw(0.9, 8, 0.9, 5)
    # the noise is a function of (seed, position): another seed, another
    # stream
    assert [_draw(1.0, 0, 1.0, i) for i in range(8)] != \
        [_draw(1.0, 0, 1.0, i, seed=1) for i in range(8)]


def test_top_p_membership():
    full = _fixture("v64")[3].astype(float)
    probs = np.exp(full - full.max())
    probs /= probs.sum()
    order = np.argsort(-probs)
    csum = np.cumsum(probs[order])
    nucleus = set(order[:int(np.searchsorted(csum, 0.4) + 1)].tolist())
    seen = {_draw(1.0, 0, 0.4, i) for i in range(24)}
    assert seen <= nucleus
    assert len(seen) > 1


def test_zero_temperature_rows_are_greedy():
    full = _fixture("v64")[3]
    for i in range(4):
        assert _draw(0.0, 0, 1.0, i) == int(np.argmax(full))


def test_keys_are_a_pure_function_of_seed_position_and_rank():
    keys = {(s, p, r): sampling.fold_in(sampling.fold_in(
        sampling.seed_key(s), p), r)
        for s in range(3) for p in range(4) for r in range(2)}
    assert len(set(keys.values())) == len(keys)
    again = sampling.fold_in(sampling.fold_in(sampling.seed_key(2), 3), 1)
    assert again == keys[(2, 3, 1)] and 0 <= again < 2 ** 64
    a = sampling.gumbel([keys[(0, 1, 0)], None], 1, 50, "cpu")
    b = sampling.gumbel([keys[(0, 1, 0)]], 1, 50, "cpu")
    c = sampling.gumbel([keys[(0, 1, 0)]], 0, 50, "cpu")
    assert torch.equal(a[:1], b) and not torch.equal(b, c)
    assert torch.isfinite(a).all()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

ARCH = "h2o-danube-1.8b"
ENG = dict(max_slots=4, page_size=4, pages_per_shard=32, max_len=128)


def _mixed_requests(vocab, cls):
    """``check_engine_mixed``'s workload: 8 requests, even greedy, odd
    sampled, one arriving per step."""
    rng = np.random.default_rng(1)
    reqs = []
    for i in range(8):
        plen = int(rng.integers(2, 28))
        gen = int(rng.integers(2, 10))
        reqs.append(cls(
            uid=f"r{i}", tokens=rng.integers(0, vocab, plen).tolist(),
            max_new_tokens=gen, temperature=0.0 if i % 2 == 0 else 0.9,
            top_k=16 * (i % 3), top_p=[1.0, 0.9, 0.8][i % 3], seed=100 + i))
    return reqs


def _run_arrivals(eng, reqs):
    pending = list(enumerate(reqs))
    while pending or not eng.idle():
        while pending and pending[0][0] <= eng.metrics.steps:
            assert eng.add_request(pending.pop(0)[1]) is None
        eng.step()
    return eng.collect()


def _engine_ctx():
    if not _CTX:
        cfg_j = jax_registry.get_smoke(ARCH)
        plan = jax_make_serve_plan(
            cfg_j, arch=ARCH, n_devices=1, c=1, decode_batch=ENG["max_slots"],
            page_size=ENG["page_size"], max_len=ENG["max_len"])
        jeng = jax_engine.build_engine(
            ARCH, smoke=True, eng=jax_engine.EngineConfig(**ENG), plan=plan)
        greedy = [r for r in _mixed_requests(cfg_j.vocab_size,
                                             jax_engine.Request)
                  if r.temperature == 0.0]
        for r in greedy:
            jeng.add_request(r)
        want = jeng.run()
        model = from_jax_params(jax.tree.map(np.asarray, jeng.params),
                                cfg_j, "cpu")
        _CTX.update(model=model, want_greedy=want)
    return _CTX


def _torch_engine(model, n_devices=1, c=1, prefix=False, chunk=0):
    plan = make_serve_plan(model.cfg, arch=ARCH, n_devices=n_devices, c=c,
                           decode_batch=ENG["max_slots"],
                           page_size=ENG["page_size"],
                           max_len=ENG["max_len"], prefix_cache=prefix)
    return torch_engine.Engine(model, plan, torch_engine.EngineConfig(
        **ENG, prefill_chunk=chunk))


def test_engine_mixed_at_c2_equals_solo_replay_and_jax_greedy():
    ctx = _engine_ctx()
    eng = _torch_engine(ctx["model"], n_devices=4, c=2)
    assert (eng.mesh.c, eng.mesh.sp_size) == (2, 4)
    vocab = eng.cfg.vocab_size
    reqs = _mixed_requests(vocab, torch_engine.Request)
    mixed = _run_arrivals(eng, reqs)
    assert all(len(mixed[r.uid]) == r.max_new_tokens for r in reqs)
    assert all(0 <= t < vocab for toks in mixed.values() for t in toks)
    eng.reset()
    assert _run_arrivals(eng, reqs) == mixed, "replay diverged"
    # the greedy rows' batch invariance is shown by the JAX engine's
    # all-greedy batch below; the sampled rows run alone
    for r in reqs:
        if r.temperature > 0.0:
            eng.reset()
            eng.add_request(r)
            assert eng.run()[r.uid] == mixed[r.uid], f"{r.uid} diverged solo"
    assert len(ctx["want_greedy"]) == 4
    for uid, toks in ctx["want_greedy"].items():
        assert mixed[uid] == toks, f"{uid}: greedy row differs from JAX"


def test_sampled_stream_unchanged_by_chunking_and_prefix_hit():
    model = _engine_ctx()["model"]
    rng = np.random.default_rng(4)
    shared = rng.integers(0, model.cfg.vocab_size, 16).tolist()
    req = torch_engine.Request(
        "s", shared + rng.integers(0, model.cfg.vocab_size, 7).tolist(), 6,
        temperature=1.1, top_k=32, top_p=0.95, seed=9)
    warm = torch_engine.Request(
        "w", shared + rng.integers(0, model.cfg.vocab_size, 3).tolist(), 2)
    streams = {}
    for name, prefix, chunk in (("monolithic", False, 0),
                                ("chunked", False, 8),
                                ("prefix_hit", True, 0)):
        eng = _torch_engine(model, prefix=prefix, chunk=chunk)
        if prefix:
            eng.add_request(warm)
            eng.run()
        eng.add_request(dataclasses.replace(req))
        streams[name] = eng.run()["s"]
        m = eng.metrics
        if chunk:
            assert m.prefill_chunks > m.prefills
        if prefix:
            assert eng.scheduler.finished["s"].cached_len == 16
    assert streams["chunked"] == streams["monolithic"]
    assert streams["prefix_hit"] == streams["monolithic"]
    greedy = dataclasses.replace(req, temperature=0.0)
    eng = _torch_engine(model)
    eng.add_request(greedy)
    assert eng.run()["s"] != streams["monolithic"]
