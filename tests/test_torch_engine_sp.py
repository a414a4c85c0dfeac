"""repro_torch's serving engine at SP degree > 1 on a ThreadMesh vs the JAX
engine.

Smoke h2o-danube-1.8b (f32, window 16) and smoke minitron-8b (f32, 4q/2kv,
no window); the JAX engine (one CPU device, P = 1) makes the weights and
``from_jax_params`` carries them into the port. The port's engine runs one
rank per ``ThreadMesh`` thread at (c, r) = (1, 4), (2, 1) and (2, 2):
StarTrail's team gathers and sub-rings in the prefill, B4's partials merged
across ranks in every decode step, B6's and B1's in every suffix chunk.

* Greedy streams bit-identical to the JAX engine's at P = 1 and to the
  port's own P = 1 engine, with a request joining mid-run; with the prefix
  cache and with chunked prefill (the reference is the JAX engine's
  monolithic prefill, as in ``tests/test_torch_prefix.py``).
* Every rank samples the same tokens: the engine raises if one differs,
  so every SP run here holds it, and a rank made to differ raises.
* ``reset()`` then a replay gives the same streams.
* One paged decode step at P = 8 (``ThreadMesh(2, 2)``, the K/V spread
  round-robin over the ranks' pools) against the JAX local-mode decode step
  on the same K/V in a contiguous cache (``check_spmd_serve``): the tokens
  equal, the hidden state within 1e-4.
* ``launch.serve --devices 8 --c 2`` on the CPU, a ``--save-plan`` then
  ``--plan`` round trip, ``--data 2``, and ``--comm-report`` with every
  live ratio at 1.0.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro import engine as jax_engine
from repro.configs import registry as jax_registry
from repro.configs.base import RunConfig as JaxRunConfig
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.models.factory import build_model as jax_build_model
from repro.plan import make_serve_plan as jax_make_serve_plan
from repro.serve import step as jax_serve_step
from repro.train import step as jax_train_step
from repro_torch import engine as torch_engine
from repro_torch.dist.comm import ThreadMesh
from repro_torch.engine import paged_cache
from repro_torch.models.factory import from_jax_params, shard_params
from repro_torch.plan import make_serve_plan
from repro_torch.serve import step as serve_step

ARCHS = ["h2o-danube-1.8b", "minitron-8b"]
LAYOUTS = [(1, 4), (2, 1), (2, 2)]
ENG = dict(max_slots=2, page_size=4, pages_per_shard=32, max_len=64)
MODES = {"prefix": (True, 0), "chunked": (False, 8),
         "prefix_chunked": (True, 8)}
_CTX = {}


def _requests(vocab, cls):
    """Two prompts, then one that joins the running batch (``_drive``)."""
    rng = np.random.default_rng(0)
    return [cls("g", rng.integers(0, vocab, 5).tolist(), 4),
            cls("long", rng.integers(0, vocab, 19).tolist(), 6),
            cls("late", rng.integers(0, vocab, 3).tolist(), 3)]


def _shared_prefix_requests(vocab, cls):
    """Three prompts sharing a 12-token (three-page) prefix, the last
    joining mid-run, and one unrelated prompt."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, 12).tolist()
    return [cls("a", shared + rng.integers(0, vocab, 5).tolist(), 4),
            cls("c", rng.integers(0, vocab, 7).tolist(), 3),
            cls("b", shared + rng.integers(0, vocab, 9).tolist(), 5),
            cls("d", shared + rng.integers(0, vocab, 2).tolist(), 4)]


def _drive(eng, reqs):
    """Queue all but the last request, step once, queue the last, run to
    the end."""
    for r in reqs[:-1]:
        assert eng.add_request(r) is None
    eng.step()
    assert eng.add_request(reqs[-1]) is None
    while not eng.idle():
        eng.step()
    return eng.collect()


def _ctx(arch):
    if arch not in _CTX:
        cfg = jax_registry.get_smoke(arch)
        plan = jax_make_serve_plan(
            cfg, arch=arch, n_devices=1, c=1, decode_batch=ENG["max_slots"],
            page_size=ENG["page_size"], max_len=ENG["max_len"])
        jeng = jax_engine.build_engine(
            arch, smoke=True, eng=jax_engine.EngineConfig(**ENG), plan=plan)
        want = {
            "joined": _drive(jeng, _requests(cfg.vocab_size,
                                             jax_engine.Request))}
        jeng.reset()
        want["prefix"] = _drive(jeng, _shared_prefix_requests(
            cfg.vocab_size, jax_engine.Request))
        tree = jax.tree.map(np.asarray, jeng.params)
        _CTX[arch] = dict(cfg=cfg, jeng=jeng, tree=tree, want=want,
                          model=from_jax_params(tree, cfg, "cpu"))
    return _CTX[arch]


def _engine(arch, c, r, prefix=False, chunk=0, data=1):
    ctx = _ctx(arch)
    plan = make_serve_plan(
        ctx["model"].cfg, arch=arch, n_devices=data * c * c * r, data=data,
        c=c, decode_batch=ENG["max_slots"], page_size=ENG["page_size"],
        max_len=ENG["max_len"], prefix_cache=prefix)
    assert (plan.c, plan.r, plan.data) == (c, r, data)
    return torch_engine.Engine(ctx["model"], plan, torch_engine.EngineConfig(
        **ENG, prefill_chunk=chunk))


@pytest.mark.parametrize("c,r", LAYOUTS, ids=["c1r4", "c2r1", "c2r2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_streams_match_jax_and_p1(arch, c, r):
    ctx = _ctx(arch)
    vocab = ctx["cfg"].vocab_size
    want = ctx["want"]["joined"]
    assert sorted(want) == ["g", "late", "long"]
    p1 = _drive(_engine(arch, 1, 1), _requests(vocab, torch_engine.Request))
    assert p1 == want
    eng = _engine(arch, c, r)
    assert eng.mesh.size == c * c * r
    got = _drive(eng, _requests(vocab, torch_engine.Request))
    assert got == want
    m = eng.metrics
    assert m.prefills == 3 and m.tokens_out == 13
    assert m.pages_total == c * c * r * ENG["pages_per_shard"]
    # reset() zeroes every rank's pools; the replay gives the same streams
    eng.reset()
    assert all(float(t.abs().sum()) == 0 for pools in eng.pools
               for t in pools.values())
    assert _drive(eng, _requests(vocab, torch_engine.Request)) == want


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("c,r", [(1, 4), (2, 2)], ids=["c1r4", "c2r2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_and_chunked_streams_match_jax(arch, c, r, mode):
    ctx = _ctx(arch)
    prefix, chunk = MODES[mode]
    eng = _engine(arch, c, r, prefix=prefix, chunk=chunk)
    reqs = _shared_prefix_requests(ctx["cfg"].vocab_size,
                                   torch_engine.Request)
    assert _drive(eng, reqs) == ctx["want"]["prefix"]
    m = eng.metrics
    assert m.prefill_tokens_computed + m.prefill_tokens_cached == sum(
        len(q.tokens) for q in reqs)
    if chunk:
        # the chunk rounds to lcm(P, page_size): suffix chunks ran B6/B1
        assert m.prefill_chunks > m.prefills
    if prefix:
        assert m.prefill_tokens_cached > 0


def test_data_replicas_compute_the_same_batch():
    """data = 2 replicas of SP degree 4: every thread (both replicas)
    samples the same tokens, and the streams are the JAX ones."""
    arch = ARCHS[0]
    ctx = _ctx(arch)
    eng = _engine(arch, 2, 1, data=2)
    assert eng.mesh.size == 8 and len(eng.pools) == 8
    assert eng.rt.batch_axes == ()
    got = _drive(eng, _requests(ctx["cfg"].vocab_size,
                                torch_engine.Request))
    assert got == ctx["want"]["joined"]


def test_ranks_that_sample_differently_raise(monkeypatch):
    """Greedy sampling reads rank 0's tokens only because every rank's are
    equal: a decode step in which rank 1's differ raises."""
    arch = ARCHS[0]
    eng = _engine(arch, 2, 1)
    decode = serve_step.lm_decode_step

    def skewed(rt, *args, **kw):
        return decode(rt, *args, **kw) + (rt.comm.rank == 1)

    monkeypatch.setattr(serve_step, "lm_decode_step", skewed)
    with pytest.raises(RuntimeError, match="ranks sampled different"):
        _drive(eng, _requests(_ctx(arch)["cfg"].vocab_size,
                              torch_engine.Request))


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_step_p8_matches_jax_local_mode(arch):
    """``check_spmd_serve``: one decode step at P = 8 over the paged pools
    against the JAX local-mode decode step over a contiguous cache holding
    the same K/V."""
    ctx = _ctx(arch)
    cfg, tree = ctx["cfg"], ctx["tree"]
    B, S, ps, sp = 2, 32, 4, 8
    L, Hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
    rng = np.random.default_rng(4)
    kv = {n: rng.normal(size=(L, B, S, Hkv, hd)).astype(np.float32)
          for n in "kv"}
    tokens = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    cache_len = np.asarray([19, 30], np.int32)

    model_j = jax_build_model(cfg)
    shape_j = JaxShapeConfig("t", seq_len=S, global_batch=B, kind="decode")
    rt_j = dataclasses.replace(jax_train_step.make_runtime(
        model_j, JaxRunConfig(c=1, seq_scheme="contiguous"), shape_j,
        mode="local"), batch_axes=())
    cache_j = {"stack": {"sub0": {n: kv[n] for n in "kv"}}}
    want_tok, _ = jax.jit(lambda p, c_, t, cl: jax_serve_step.lm_decode_step(
        rt_j, p, c_, t, cfg, cl))(tree, cache_j, tokens, cache_len)

    # block g of row b lives on rank g % sp as that rank's page b
    # (S / ps = 8 blocks a row: one block a row on every rank)
    pools = []
    for rank in range(sp):
        blk = {n: kv[n][:, :, rank * ps:(rank + 1) * ps] for n in "kv"}
        pools.append({n: torch.from_numpy(np.ascontiguousarray(blk[n]))
                      for n in "kv"})                  # (L, B pages, ps, ..)
    table = np.broadcast_to(np.arange(B, dtype=np.int32)[:, None, None],
                            (B, sp, 1)).copy()
    paged = paged_cache.PagedTables(table=table, cache_len=cache_len,
                                    active=np.ones(B, bool), page_size=ps,
                                    device=torch.device("cpu"))
    model = ctx["model"]
    plan = make_serve_plan(cfg, arch=arch, n_devices=sp, c=2,
                           decode_batch=B, page_size=ps, max_len=S)
    rt0 = torch_engine.Engine(model, plan, torch_engine.EngineConfig(
        **{**ENG, "pages_per_shard": B})).rt
    tok_t = torch.from_numpy(tokens.astype(np.int64))
    cl_t = torch.from_numpy(cache_len)

    def rank_fn(comm):
        rt = dataclasses.replace(rt0, comm=comm)
        tree = shard_params(model, comm, rt.rules)   # the rank's shards
        with torch.no_grad():
            tok = serve_step.lm_decode_step(rt, tree, pools[comm.rank],
                                            tok_t, cfg, cl_t, paged)
            hid = serve_step.lm_decode_step(
                rt, tree, {n: t.clone() for n, t in pools[comm.rank].items()},
                tok_t, cfg, cl_t, paged, return_hidden=True)
        return tok, hid

    out = ThreadMesh(2, 2).run(rank_fn, timeout=120)
    for tok, _ in out:
        np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    # the local mode's hidden state: one rank, the K/V contiguous
    rt1 = torch_engine.Engine(model, make_serve_plan(
        cfg, arch=arch, decode_batch=B, page_size=ps, max_len=S)).rt
    one = {n: torch.from_numpy(kv[n].reshape(L, B, S // ps, ps, Hkv, hd)
                               .reshape(L, B * S // ps, ps, Hkv, hd).copy())
           for n in "kv"}
    table1 = np.arange(B * S // ps, dtype=np.int32).reshape(B, 1, S // ps)
    with torch.no_grad():
        want_h = serve_step.lm_decode_step(
            rt1, model, one, tok_t, cfg, cl_t, paged_cache.PagedTables(
                table=table1, cache_len=cache_len, active=np.ones(B, bool),
                page_size=ps, device=torch.device("cpu")),
            return_hidden=True)
    for _, hid in out:
        np.testing.assert_allclose(hid.numpy(), want_h.numpy(), atol=1e-4,
                                   rtol=1e-4)


def test_launch_serve_devices_plan_and_comm_report(tmp_path):
    from repro_torch.launch import serve

    arch = ARCHS[0]
    base = ["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
            "--prompt-len", "9", "--gen", "3"]
    plan_file = tmp_path / "serve_plan.json"
    report = tmp_path / "comm.json"
    out = serve.main(base + ["--devices", "8", "--c", "2", "--save-plan",
                             str(plan_file), "--comm-report", str(report)])
    assert sorted(out) == ["req0", "req1", "req2"]
    rec = json.loads(plan_file.read_text())["plan"]
    assert (rec["n_devices"], rec["c"], rec["r"], rec["kind"]) == \
        (8, 2, 2, "decode")
    rep = json.loads(report.read_text())
    live = {k: v["ratio"] for k, v in rep["per_collective"].items()
            if v["analytical_bytes"]}
    assert live and all(x == 1.0 for x in live.values())
    # a kind the island does not run moves nothing
    assert all(v["ratio"] is None for v in rep["per_collective"].values()
               if not v["analytical_bytes"])
    assert rep["within_tolerance"]
    # the plan file alone serves the same streams
    assert serve.main(["--plan", str(plan_file), "--smoke", "--device", "cpu",
                       "--requests", "3", "--prompt-len", "9",
                       "--gen", "3"]) == out
    # two data replicas of SP degree 4 give the same streams again
    assert serve.main(base + ["--devices", "8", "--data", "2",
                              "--c", "2"]) == out
