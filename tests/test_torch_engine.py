"""repro_torch's serving engine vs the JAX engine on the same weights.

The JAX engine (``repro.engine``, smoke h2o-danube-1.8b, one CPU device,
P = 1) makes the parameters; ``repro_torch.models.factory.from_jax_params``
carries them into the port's engine on the CPU. The greedy token streams
must be identical, with a request joining mid-run; the prefill's
next-token hidden state must agree within 1e-4 (f32 smoke weights, the
same products in another summation order), and so must the local-mode
forward (one attention block per layer) of both packages. The port's own
"batched == solo" replay must hold, and the knobs the port does not carry
yet must raise (an SP degree > 1, temperature > 0, the host tier and
preemption no longer do: ``tests/test_torch_host_tier.py``). The prefix cache and chunked prefill are held against the
JAX engine in ``tests/test_torch_prefix.py``. The paper's GPT-3B, cut to
2 layers and narrow widths but keeping its head size 256 and MHA, streams
the JAX engine's greedy tokens with pages of 128 and a prefix hit: the
path on which the card runs B4 and B6 at head size 256.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import engine as jax_engine
from repro.configs import paper_models as jax_paper_models
from repro.configs import registry as jax_registry
from repro.models.factory import build_model as jax_build_model
from repro.dist.sharding import SP_AXES
from repro.plan import make_serve_plan as jax_make_serve_plan
from repro.serve import step as jax_serve_step
from repro_torch import engine as torch_engine
from repro_torch.configs import paper_models
from repro_torch.models.factory import from_jax_params
from repro_torch.plan import make_serve_plan

ARCH = "h2o-danube-1.8b"
ENG = dict(max_slots=2, page_size=4, pages_per_shard=32, max_len=64)
_CTX = {}


def _requests(vocab, cls):
    rng = np.random.default_rng(0)
    return [cls("g", rng.integers(0, vocab, 5).tolist(), 4),
            cls("long", rng.integers(0, vocab, 13).tolist(), 6),
            cls("late", rng.integers(0, vocab, 3).tolist(), 3)]


def _drive(eng, reqs):
    eng.add_request(reqs[0])
    eng.add_request(reqs[1])
    eng.step()
    eng.add_request(reqs[2])                     # joins the running batch
    return eng.run()


def _engines():
    if not _CTX:
        cfg = jax_registry.get_smoke(ARCH)
        plan = jax_make_serve_plan(
            cfg, arch=ARCH, n_devices=1, c=1, decode_batch=ENG["max_slots"],
            page_size=ENG["page_size"], max_len=ENG["max_len"])
        jeng = jax_engine.build_engine(
            ARCH, smoke=True, eng=jax_engine.EngineConfig(**ENG), plan=plan)
        tree = jax.tree.map(np.asarray, jeng.params)
        model = from_jax_params(tree, cfg, "cpu")
        teng = torch_engine.build_engine(
            ARCH, smoke=True, eng=torch_engine.EngineConfig(**ENG),
            model=model, device="cpu")
        vocab = cfg.vocab_size
        j_out = _drive(jeng, _requests(vocab, jax_engine.Request))
        t_out = _drive(teng, _requests(vocab, torch_engine.Request))
        _CTX.update(cfg=cfg, jeng=jeng, teng=teng, j_out=j_out, t_out=t_out)
    return _CTX


def test_greedy_streams_identical_to_jax_engine():
    ctx = _engines()
    assert sorted(ctx["t_out"]) == ["g", "late", "long"]
    assert [len(ctx["t_out"][u]) for u in ("g", "long", "late")] == [4, 6, 3]
    assert ctx["t_out"] == ctx["j_out"]
    m = ctx["teng"].metrics
    assert m.prefills == 3 and m.tokens_out == 13 and m.finished == 3


def test_prefill_hidden_matches_jax():
    ctx = _engines()
    cfg, jeng, teng = ctx["cfg"], ctx["jeng"], ctx["teng"]
    tokens = _requests(cfg.vocab_size, torch_engine.Request)[1].tokens
    plen, bucket = len(tokens), 16
    rt = dataclasses.replace(jeng.rt, st_cfg=dataclasses.replace(
        jeng.rt.st_cfg, seq_len=bucket))
    fn = jax.jit(jax.shard_map(
        lambda params, toks, pl: jax_serve_step.lm_prefill(
            rt, params, {"tokens": toks}, cfg, prompt_len=pl,
            return_hidden=True)[0],
        mesh=jeng.mesh, in_specs=(jeng._param_specs, P(None, SP_AXES), P()),
        out_specs=P(), check_vma=False))
    buf = np.zeros((1, bucket), np.int32)
    buf[0, :plen] = tokens
    want = np.asarray(fn(jeng.params, buf, np.asarray([plen], np.int32)))
    # the port prefills at the prompt's own length (no compile buckets)
    got, (k_stack, _) = teng.prefill_hidden(tokens)
    assert k_stack.shape == (cfg.num_layers, 1, plen, cfg.num_kv_heads,
                             cfg.head_dim_)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_local_attention_prefill_matches_jax_local_mode():
    """``Runtime(attention_impl='local')`` (one ``dispatch.prefill``, the B1
    kernel on the card) against the JAX ``Runtime(mode='local')`` forward,
    and against the port's own StarTrail route (B2 on the card)."""
    ctx = _engines()
    cfg, jeng, teng = ctx["cfg"], ctx["jeng"], ctx["teng"]
    tokens = _requests(cfg.vocab_size, torch_engine.Request)[1].tokens
    rt_j = dataclasses.replace(
        jeng.rt, mode="local",
        st_cfg=dataclasses.replace(jeng.rt.st_cfg, seq_len=len(tokens)))
    want, _ = jax_serve_step.lm_prefill(
        rt_j, jeng.params, {"tokens": np.asarray([tokens], np.int32)}, cfg,
        return_hidden=True)
    local, (k_local, _) = teng.prefill_hidden(
        tokens, rt=dataclasses.replace(teng.rt, attention_impl="local"))
    ring, (k_ring, _) = teng.prefill_hidden(tokens)
    np.testing.assert_allclose(local.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(local.numpy(), ring.numpy(), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(k_local.numpy(), k_ring.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_batched_equals_solo_replay():
    ctx = _engines()
    teng, out = ctx["teng"], ctx["t_out"]
    for r in _requests(ctx["cfg"].vocab_size, torch_engine.Request):
        teng.reset()
        teng.add_request(r)
        assert teng.run()[r.uid] == out[r.uid], f"{r.uid} diverged solo"
    teng.reset()
    assert _drive(teng, _requests(ctx["cfg"].vocab_size,
                                  torch_engine.Request)) == out


def test_unported_knobs_raise():
    ctx = _engines()
    cfg, teng = ctx["cfg"], ctx["teng"]
    # temperature > 0 is served (held in tests/test_torch_sampling.py)
    teng.reset()
    assert teng.add_request(torch_engine.Request(
        "s", [1, 2], 2, temperature=0.8, top_k=4, seed=3)) is None
    out = teng.run()["s"]
    assert len(out) == 2 and all(0 <= t < cfg.vocab_size for t in out)
    # the host tier needs the prefix cache (tests/test_torch_host_tier.py)
    with pytest.raises(ValueError, match="prefix_cache"):
        make_serve_plan(cfg, page_size=4, max_len=64, host_tier_bytes=1)
    assert teng.preempt("nope") is None
    # SP degree > 1 runs on a ThreadMesh (tests/test_torch_engine_sp.py)
    sp4 = torch_engine.Engine(teng.model, make_serve_plan(
        cfg, n_devices=4, c=1, page_size=4, max_len=64))
    assert sp4.mesh.sp_size == 4 and len(sp4.pools) == 4
    rej = teng.add_request(torch_engine.Request("big", [1] * 60, 10))
    assert rej is not None and rej.reason == "too_long"


def test_launch_serve_cpu_and_rejected_modes():
    from repro_torch.launch import serve

    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--requests", "2", "--prompt-len", "6", "--gen", "3"])
    assert sorted(out) == ["req0", "req1"]
    # the static-batch path runs one replica (--replicas, --roles and
    # --http are served: tests/test_torch_gateway.py, test_torch_frontend.py)
    with pytest.raises(NotImplementedError, match="--legacy"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--legacy", "--replicas", "2"])
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--requests", "3", "--prompt-len", "6", "--gen", "3",
                      "--prefix-cache", "--system-prompt-len", "16",
                      "--prefill-chunk", "8"])
    assert sorted(out) == ["req0", "req1", "req2"]


# GPT-3B at head size 256, cut to 2 layers and narrow widths, built the
# same way in both packages; pages of 128 keys, two slots of 512 tokens
GPT3B_NARROW = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
                    d_ff=128, vocab_size=256, param_dtype="float32")
GPT3B_ENG = dict(max_slots=2, page_size=128, pages_per_shard=12,
                 max_len=512)


def _gpt3b_requests(vocab, cls):
    """A prompt whose first 128-token page the next two reuse (a prefix
    hit of one page each), one joining mid-run."""
    rng = np.random.default_rng(7)
    shared = rng.integers(0, vocab, 150).tolist()
    return [cls("first", shared + rng.integers(0, vocab, 10).tolist(), 5),
            cls("hit", shared + rng.integers(0, vocab, 40).tolist(), 6),
            cls("late", shared[:130] + rng.integers(0, vocab, 3).tolist(),
                4)]


def _drive_gpt3b(eng, reqs):
    eng.add_request(reqs[0])
    out = eng.run()                    # "first" finishes: its pages cached
    eng.add_request(reqs[1])
    eng.step()
    eng.add_request(reqs[2])           # joins the running batch
    out.update(eng.run())
    return out


def test_gpt3b_head256_streams_with_prefix_hit_match_jax_engine():
    cfg_j = dataclasses.replace(jax_paper_models.GPT_3B, **GPT3B_NARROW)
    cfg = dataclasses.replace(paper_models.GPT_3B, **GPT3B_NARROW)
    assert cfg.head_dim_ == 256 and cfg.num_heads == cfg.num_kv_heads
    model_j = jax_build_model(cfg_j)
    params = model_j.init(jax.random.PRNGKey(0))
    kw = dict(arch="gpt-3b", c=1, decode_batch=GPT3B_ENG["max_slots"],
              page_size=GPT3B_ENG["page_size"],
              max_len=GPT3B_ENG["max_len"], prefix_cache=True)
    jeng = jax_engine.Engine(
        model_j, jax_make_serve_plan(cfg_j, n_devices=1, **kw),
        jax_engine.EngineConfig(**GPT3B_ENG), params)
    teng = torch_engine.Engine(
        from_jax_params(jax.tree.map(np.asarray, params), cfg, "cpu"),
        make_serve_plan(cfg, **kw), torch_engine.EngineConfig(**GPT3B_ENG))
    want = _drive_gpt3b(jeng, _gpt3b_requests(cfg.vocab_size,
                                              jax_engine.Request))
    got = _drive_gpt3b(teng, _gpt3b_requests(cfg.vocab_size,
                                             torch_engine.Request))
    assert [len(got[u]) for u in ("first", "hit", "late")] == [5, 6, 4]
    assert got == want
    # both later prompts reused the first one's 128-token page
    assert teng.metrics.prefill_tokens_cached == \
        jeng.metrics.prefill_tokens_cached == 2 * 128
