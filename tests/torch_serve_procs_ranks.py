"""Rank functions for ``tests/test_torch_serve_procs.py``.

The ranks of a ``dist.procs.ProcessMesh`` import this module (``spawn``
pickles a function by its module and name), so it imports ``torch`` and
``repro_torch`` only: no JAX, nothing of ``repro``. The ``observe_*``
functions take an engine, so the test runs them on the ``ThreadMesh``
engine for the reference as the rank processes run them on theirs.
"""

import sys

import torch

from repro_torch import engine as torch_engine
from repro_torch.configs import registry
from repro_torch.dist.sharding import MESH_AXES
from repro_torch.launch import serve as launch_serve
from repro_torch.models.factory import (build_rank_model, from_jax_params,
                                        rank_model)
from repro_torch.serve import step as serve_step

ARCH = "h2o-danube-1.8b"


def _ledgers(eng):
    """Every rank's ledger this engine holds: a ThreadMesh's, or this
    rank process's (or one card's) one."""
    return eng.mesh.ledgers if eng.mesh is not None else [eng.rt.comm.ledger]


def _run_joined(eng, reqs):
    """Queue all but the last request, step once, queue the last, run to
    the end (``test_torch_engine_sp._drive``)."""
    for r in reqs[:-1]:
        assert eng.add_request(r) is None
    eng.step()
    assert eng.add_request(reqs[-1]) is None
    while not eng.idle():
        eng.step()
    return eng.collect()


def _run_each(eng, reqs):
    """Each request alone to the end, in turn (the host tier's pool
    pressure, ``test_torch_host_tier._serve_pressure``)."""
    out = {}
    for r in reqs:
        assert eng.add_request(r) is None
        out.update(eng.run())
    return out


RUNS = {"joined": _run_joined, "each": _run_each}


def observe(eng, reqs, run):
    """Serve ``reqs`` on ``eng`` by ``RUNS[run]``: the streams, each
    request's first-token hidden state, every ledger the engine holds
    (reset first), the connector's counters and the engine's counts."""
    hidden = {}
    eng.on_prefill = lambda uid, h: hidden.__setitem__(uid, h.clone())
    for ledger in _ledgers(eng):
        ledger.reset()
    streams = RUNS[run](eng, reqs)
    eng.on_prefill = None
    m = eng.metrics
    return dict(streams=streams, hidden=hidden,
                ledgers=[led.snapshot() for led in _ledgers(eng)],
                stats=eng.connector.stats(),
                counts={k: getattr(m, k) for k in (
                    "prefills", "prefill_chunks", "decode_steps",
                    "tokens_out", "prefill_tokens_cached",
                    "prefill_tokens_host")})


def observe_handoff(pre, dec, reqs):
    """The JAX gateway's prefill -> decode handoff between two engines
    (``test_torch_host_tier._serve_handoff``): 1-token ``handoff`` twins on
    ``pre``, each exported, released and added to ``dec``. Returns the
    streams, the exported pages by uid and both connectors' counters."""
    import dataclasses

    for r in reqs:
        assert pre.add_request(dataclasses.replace(
            r, max_new_tokens=1, handoff=True)) is None
    by_uid = {r.uid: r for r in reqs}
    first, pages = {}, {}
    while not (pre.idle() and dec.idle()):
        for eng in (pre, dec):
            if not eng.idle():
                eng.step()
        for st in pre.take_handoffs():
            orig = by_uid[st.req.uid]
            first[orig.uid] = st.out[0]
            if orig.max_new_tokens > 1:
                blocks = pre.export_kv(st)
                pages[orig.uid] = [{n: t.clone() for n, t in b.items()}
                                   for b in blocks]
                pre.release_handoff(st)
                dec.add_prefilled(orig, st.out[0], blocks)
            else:
                pre.release_handoff(st)
    out = dec.collect()
    streams = {u: (out[u] if u in out else [first[u]]) for u in by_uid}
    return dict(streams=streams, pages=pages,
                stats=[pre.connector.stats(), dec.connector.stats()])


def _model(comm, tree, plan):
    cfg = registry.get_smoke(ARCH)
    return rank_model(from_jax_params(tree, cfg, "cpu"), comm,
                      plan.sharding_rules)


def _engine(comm, model, plan, eng_cfg):
    return torch_engine.Engine(model, plan, eng_cfg, comm=comm)


def serve(comm, tree, plan, eng_cfg, reqs, run):
    """``observe`` of this rank's engine on its ``rank_model``."""
    return observe(_engine(comm, _model(comm, tree, plan), plan, eng_cfg),
                   reqs, run)


def handoff(comm, tree, plan, eng_cfg, reqs):
    """``observe_handoff`` between two engines of this rank, sharing its
    ``rank_model``."""
    model = _model(comm, tree, plan)
    return observe_handoff(_engine(comm, model, plan, eng_cfg),
                           _engine(comm, model, plan, eng_cfg), reqs)


def legacy(comm, tree, plan, tokens, gen):
    """``launch.serve.legacy_generate`` of the static batch on this rank."""
    return launch_serve.legacy_generate(_model(comm, tree, plan), plan,
                                        tokens, gen, comm=comm)


def diverge(comm, tree, plan, eng_cfg, reqs):
    """Rank 1 samples other tokens than the rest at every decode step:
    each rank's error message (None where it did not raise), and a psum
    after it, which must still meet."""
    eng = _engine(comm, _model(comm, tree, plan), plan, eng_cfg)
    decode = serve_step.lm_decode_step

    def skewed(rt, *args, **kw):
        return decode(rt, *args, **kw) + (rt.comm.rank == 1)

    serve_step.lm_decode_step = skewed
    try:
        _run_joined(eng, reqs)
        error = None
    except RuntimeError as e:
        error = str(e)
    finally:
        serve_step.lm_decode_step = decode
    return error, comm.psum(torch.ones(3), MESH_AXES)


def serve_card(comm, cfg, plan, eng_cfg, reqs):
    """This rank's engine on its card (``tests/test_torch_gpu.py``): the
    model drawn there from seed 0 and its shards kept; the streams of the
    ``joined`` run and the kernels' launches in it."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode as pd

    model = build_rank_model(cfg, comm, plan.sharding_rules, "cuda", seed=0)
    eng = _engine(comm, model, plan, eng_cfg)
    fa.reset_launches()
    pd.reset_launches()
    streams = observe(eng, reqs, "joined")["streams"]
    return streams, {**fa.LAUNCHES, **pd.LAUNCHES}


def imports(comm):
    """The JAX and ``repro`` modules this rank process has imported."""
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib"))
                  or m == "repro" or m.startswith("repro."))


def jobs(comm, *calls):
    """Each (function name, args) of this module in turn on this rank,
    the results in order: one spawn of the mesh serves many checks."""
    return [globals()[name](comm, *args) for name, args in calls]
