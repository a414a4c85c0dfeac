"""repro_torch's serving engine vs the JAX engine on the same weights.

The JAX engine (``repro.engine``, smoke h2o-danube-1.8b, one CPU device,
P = 1) makes the parameters; ``repro_torch.models.factory.from_jax_params``
carries them into the port's engine on the CPU. The greedy token streams
must be identical, with a request joining mid-run; the prefill's
next-token hidden state must agree within 1e-4 (f32 smoke weights, the
same products in another summation order), and so must the local-mode
forward (one attention block per layer) of both packages. The port's own
"batched == solo" replay must hold, and the knobs this slice does not port
must raise.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import engine as jax_engine
from repro.configs import registry as jax_registry
from repro.dist.sharding import SP_AXES
from repro.plan import make_serve_plan as jax_make_serve_plan
from repro.serve import step as jax_serve_step
from repro_torch import engine as torch_engine
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
    with pytest.raises(NotImplementedError, match="temperature"):
        teng.add_request(torch_engine.Request("s", [1, 2], 2,
                                              temperature=0.8))
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        torch_engine.Engine(teng.model, teng.plan,
                            torch_engine.EngineConfig(prefill_chunk=8))
    with pytest.raises(NotImplementedError, match="prefix cache"):
        torch_engine.Engine(teng.model, dataclasses.replace(
            teng.plan, prefix_cache=True))
    with pytest.raises(NotImplementedError, match="host KV tier"):
        torch_engine.Engine(teng.model, teng.plan,
                            torch_engine.EngineConfig(host_tier_bytes=1))
    with pytest.raises(NotImplementedError, match="preemption"):
        teng.preempt("g")
    with pytest.raises(NotImplementedError, match="cost model"):
        make_serve_plan(cfg, c=None)
    with pytest.raises(NotImplementedError, match="SP degree"):
        torch_engine.Engine(teng.model, make_serve_plan(
            cfg, n_devices=4, c=1, page_size=4, max_len=64))
    rej = teng.add_request(torch_engine.Request("big", [1] * 60, 10))
    assert rej is not None and rej.reason == "too_long"


def test_launch_serve_cpu_and_rejected_modes():
    from repro_torch.launch import serve

    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--requests", "2", "--prompt-len", "6", "--gen", "3"])
    assert sorted(out) == ["req0", "req1"]
    with pytest.raises(NotImplementedError, match="--legacy"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--legacy"])
