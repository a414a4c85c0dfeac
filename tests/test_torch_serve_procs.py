"""repro_torch's serving with ranks as processes: an ``Engine`` in every
``dist.comm.ProcessComm`` rank process over gloo on the CPU (SPMD, each
fed the same requests), and the static batch's steps, against the
``ThreadMesh`` engine and the JAX engine.

Two spawns of four rank processes (``tests/torch_serve_procs_ranks.py``,
which imports no JAX) serve every engine check, on the smoke
h2o-danube-1.8b (f32, 2 layers, window 16) with the JAX weights
(``from_jax_params``, each rank keeping its ``rank_model``) and the
engine shapes of ``test_torch_engine_sp.py``; meshes are named (data, C,
R):

* at (1, 2, 1): greedy streams with a request joining mid-run, the
  prefix cache with chunked prefill, chunked prefill alone, sampled rows,
  the host tier's spill and reload under pool pressure, the prefill ->
  decode handoff (its exported pages), and a rank made to sample other
  tokens; no child imports JAX or ``repro``;
* at (2, 1, 2): data replicas' greedy streams, and ``--legacy``'s static
  batch split over ``data``.

Exact, against the ``ThreadMesh`` engine at the same plan: every stream,
each first-token hidden state bit for bit, every rank's ledger, the
connector's ``stats()``, the exported pages bit for bit. Against the JAX
engine at P = 1: the greedy streams exactly (the prefix and chunked ones
against its monolithic prefill), the hidden states within 1e-5. A rank
that samples differently makes every rank raise, and the ranks meet in a
collective after it. Also: ``launch.serve --backend gloo`` prints
``--backend threads``' streams, and the gateway and front end refuse
processes.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_serve_procs_ranks as ranks
from repro.dist.sharding import SP_AXES as JAX_SP_AXES
from repro.serve import step as jax_serve_step
from repro_torch import engine as torch_engine
from repro_torch.dist.procs import ProcessMesh
from repro_torch.launch import serve as launch_serve
from repro_torch.plan import make_serve_plan
from test_torch_engine_sp import (ENG, _ctx, _requests,
                                  _shared_prefix_requests)
from test_torch_host_tier import (TIER, _handoff_requests,
                                  _pressure_requests, _tight)

ARCH = ranks.ARCH
RUN_TIMEOUT = 240.0
# (data, C, R) -> (c, r, data)
MESHES = {"121": (2, 1, 1), "212": (1, 2, 2)}
# mode -> (prefix cache, prefill chunk)
MODES = {"prefix_chunked": (True, 8), "chunked": (False, 8)}
SAMPLING = dict(temperature=0.8, top_k=6, top_p=0.9)
LEGACY = {"batch": 2, "prompt": 16, "gen": 5}
HIDDEN_TOL = 1e-5          # the port's f32 hidden state against JAX's


def _plan(key, prefix=False, tier=0, eng=ENG):
    c, r, data = MESHES[key]
    return make_serve_plan(
        _ctx(ARCH)["cfg"], arch=ARCH, n_devices=data * c * c * r, data=data,
        c=c, decode_batch=eng["max_slots"], page_size=eng["page_size"],
        max_len=eng["max_len"], prefix_cache=prefix, host_tier_bytes=tier)


def _eng_cfg(chunk=0, eng=ENG):
    return torch_engine.EngineConfig(**eng, prefill_chunk=chunk)


def _reqs(kind):
    vocab = _ctx(ARCH)["cfg"].vocab_size
    cls = torch_engine.Request
    if kind == "joined":
        return _requests(vocab, cls)
    if kind == "prefix":
        return _shared_prefix_requests(vocab, cls)
    if kind == "sampled":
        return [dataclasses.replace(r, seed=10 + i, **SAMPLING)
                if i != 1 else r for i, r in enumerate(_requests(vocab, cls))]
    if kind == "pressure":
        return _pressure_requests(vocab, cls)
    return _handoff_requests(vocab, cls)


def _legacy_tokens():
    rng = np.random.default_rng(3)
    return torch.from_numpy(rng.integers(
        0, _ctx(ARCH)["cfg"].vocab_size,
        (LEGACY["batch"], LEGACY["prompt"])))


# every engine check: (spawn, job name, its arguments but the tree, the
# ThreadMesh reference's (plan, engine config, requests, run))
def _cases():
    cases = {
        "greedy": ("121", _plan("121"), _eng_cfg(), _reqs("joined"),
                   "joined"),
        "sampled": ("121", _plan("121"), _eng_cfg(), _reqs("sampled"),
                    "joined"),
        # the tight pool of 8 pages over the 4 SP shards
        "host_tier": ("121", _plan("121", prefix=True, tier=TIER,
                                   eng=_tight(4, 1)),
                      _eng_cfg(eng=_tight(4, 1)), _reqs("pressure"), "each"),
        "data_replicas": ("212", _plan("212"), _eng_cfg(), _reqs("joined"),
                          "joined"),
    }
    for mode, (prefix, chunk) in MODES.items():
        cases[mode] = ("121", _plan("121", prefix=prefix), _eng_cfg(chunk),
                       _reqs("prefix"), "joined")
    return cases


ENGINE_CASES = ("greedy", "sampled", "host_tier", "data_replicas",
                *MODES)


def _proc_run(key, *calls):
    c, r, data = MESHES[key]
    return ProcessMesh(c, r, data, device="cpu", timeout=120.0).run(
        ranks.jobs, *calls, timeout=RUN_TIMEOUT)


@pytest.fixture(scope="module")
def runs():
    """Both spawns' results, by check name: every rank's result."""
    tree = _ctx(ARCH)["tree"]
    cases = _cases()
    calls = {"121": [("imports", ())], "212": []}
    names = {"121": ["imports"], "212": []}
    for name in ENGINE_CASES:
        key, plan, eng_cfg, reqs, run = cases[name]
        calls[key].append(("serve", (tree, plan, eng_cfg, reqs, run)))
        names[key].append(name)
    calls["121"].append(("handoff", (tree, _plan("121"), _eng_cfg(),
                                     _reqs("handoff"))))
    names["121"].append("handoff")
    calls["212"].append(("legacy", (tree, _plan("212"), _legacy_tokens(),
                                    LEGACY["gen"])))
    names["212"].append("legacy")
    # last: the engines after it would meet a rank that raised mid-step
    calls["121"].append(("diverge", (tree, _plan("121"), _eng_cfg(),
                                     _reqs("joined"))))
    names["121"].append("diverge")
    out = {}
    for key in calls:
        got = _proc_run(key, *calls[key])
        for i, name in enumerate(names[key]):
            out[name] = [rank[i] for rank in got]
    return out


def _threads(name):
    _, plan, eng_cfg, reqs, run = _cases()[name]
    eng = torch_engine.Engine(_ctx(ARCH)["model"], plan, eng_cfg)
    return ranks.observe(eng, reqs, run)


def _same_hidden(a, b):
    return sorted(a) == sorted(b) and all(
        a[u].dtype == b[u].dtype and torch.equal(a[u], b[u]) for u in a)


@pytest.mark.parametrize("name", ENGINE_CASES)
def test_engine_on_processes_matches_thread_mesh(runs, name):
    """Streams, first-token hidden states, ledgers, connector counters and
    the engine's counts of every rank process against the ThreadMesh
    engine's, exactly."""
    want = _threads(name)
    got = runs[name]
    assert want["streams"] and all(len(s) for s in want["streams"].values())
    ledgers = [g["ledgers"][0] for g in got]
    assert ledgers == want["ledgers"]
    assert any(v for led in ledgers for v in led["forward"].values())
    for rank in got:
        assert rank["streams"] == want["streams"], name
        assert _same_hidden(rank["hidden"], want["hidden"]), name
        assert rank["stats"] == want["stats"], name
        assert rank["counts"] == want["counts"], name
    if name == "host_tier":
        # spills and reloads happened, and the counters are every rank's
        assert want["stats"]["reload_pages"] >= 4
        assert want["stats"]["spill_pages"] > 0
        assert want["counts"]["prefill_tokens_host"] > 0


@pytest.mark.parametrize("name", ["greedy", "data_replicas", *MODES])
def test_greedy_streams_equal_the_jax_engine(runs, name):
    ctx = _ctx(ARCH)
    want = ctx["want"]["joined" if name in ("greedy", "data_replicas")
                       else "prefix"]
    for rank in runs[name]:
        assert rank["streams"] == want, name
    if name in MODES:
        counts = runs[name][0]["counts"]
        assert counts["prefill_chunks"] > counts["prefills"]
        assert (counts["prefill_tokens_cached"] > 0) == MODES[name][0]


def _jax_hidden(tokens):
    """The JAX engine's (P = 1) next-token hidden state of one prompt
    (``test_torch_engine.test_prefill_hidden_matches_jax``)."""
    jeng = _ctx(ARCH)["jeng"]
    cfg = _ctx(ARCH)["cfg"]
    bucket = 1 << max(len(tokens) - 1, 1).bit_length()
    rt = dataclasses.replace(jeng.rt, st_cfg=dataclasses.replace(
        jeng.rt.st_cfg, seq_len=bucket))
    fn = jax.jit(jax.shard_map(
        lambda params, toks, pl: jax_serve_step.lm_prefill(
            rt, params, {"tokens": toks}, cfg, prompt_len=pl,
            return_hidden=True)[0],
        mesh=jeng.mesh, in_specs=(jeng._param_specs, P(None, JAX_SP_AXES),
                                  P()),
        out_specs=P(), check_vma=False))
    buf = np.zeros((1, bucket), np.int32)
    buf[0, :len(tokens)] = tokens
    return np.asarray(fn(jeng.params, buf,
                         np.asarray([len(tokens)], np.int32)))


def test_hidden_states_within_tolerance_of_the_jax_engine(runs):
    reqs = {r.uid: r for r in _reqs("joined")}
    got = runs["greedy"][0]["hidden"]
    assert sorted(got) == sorted(reqs)
    for uid, h in got.items():
        np.testing.assert_allclose(h.numpy(), _jax_hidden(reqs[uid].tokens),
                                   atol=HIDDEN_TOL, rtol=HIDDEN_TOL)


def test_handoff_exports_the_thread_mesh_pages(runs):
    plan = _plan("121")
    model = _ctx(ARCH)["model"]
    want = ranks.observe_handoff(
        torch_engine.Engine(model, plan, _eng_cfg()),
        torch_engine.Engine(model, plan, _eng_cfg()), _reqs("handoff"))
    assert want["pages"] and want["stats"][0]["handoff_out_pages"] > 0
    for rank in runs["handoff"]:
        assert rank["streams"] == want["streams"]
        assert rank["stats"] == want["stats"]
        assert sorted(rank["pages"]) == sorted(want["pages"])
        for uid, blocks in want["pages"].items():
            assert len(rank["pages"][uid]) == len(blocks)
            for a, b in zip(rank["pages"][uid], blocks):
                assert all(torch.equal(a[n], b[n]) for n in ("k", "v"))


def test_a_rank_that_samples_differently_raises_on_every_rank(runs):
    for error, after in runs["diverge"]:
        assert error is not None and "ranks sampled different" in error
        assert torch.equal(after, torch.full((3,), 4.0))


def test_rank_processes_import_no_jax(runs):
    assert runs["imports"] == [[]] * 4


def test_legacy_on_processes_matches_thread_mesh(runs):
    """``--legacy`` at (2, 1, 2): the batch of 2 split over the data
    replicas, every rank process's (B, gen) equal to the ThreadMesh's
    ``legacy_generate``."""
    plan = _plan("212")
    want = launch_serve.legacy_generate(_ctx(ARCH)["model"], plan,
                                        _legacy_tokens(), LEGACY["gen"])
    assert want.shape == (LEGACY["batch"], LEGACY["gen"])
    for got in runs["legacy"]:
        assert torch.equal(got, want)


LAUNCH = ["--arch", ARCH, "--smoke", "--device", "cpu", "--devices", "4",
          "--c", "2", "--requests", "4", "--prompt-len", "12", "--gen", "4"]


def test_launch_serve_gloo_prints_the_threads_streams(capfd):
    want = launch_serve.main(LAUNCH)
    want_lines = [line for line in capfd.readouterr().out.splitlines()
                  if line.startswith("[serve] req")]
    got = launch_serve.main(LAUNCH + ["--backend", "gloo"])
    got_lines = [line for line in capfd.readouterr().out.splitlines()
                 if line.startswith("[serve] req")]
    assert got == want and len(want) == 4
    assert got_lines == want_lines


@pytest.mark.parametrize("flags", [["--replicas", "2"], ["--http"],
                                   ["--roles", "prefill,decode"],
                                   ["--prefix-cache"]],
                         ids=["replicas", "http", "roles", "prefix_cache"])
def test_launch_serve_gateway_and_front_end_refuse_processes(flags):
    with pytest.raises(NotImplementedError,
                       match="gateway and front end on process replicas"):
        launch_serve.main(LAUNCH + ["--backend", "gloo"] + flags)
