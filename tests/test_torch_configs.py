"""The port's dense configs at head size 128 and 80 (minitron-8b,
deepseek-7b, stablelm-3b, and the paper's GPT-7B) against the JAX package.

* Every ported arch's ``CONFIG`` and ``smoke_config()``, the paper's three
  models and their ``smoke_config()`` equal the JAX ones field for field
  (``dataclasses.asdict``); the registry lists exactly the four dense archs
  and raises ``NotImplementedError`` for every other JAX arch.
* Loss and every gradient leaf of each smoke config (f32 weights carried
  over by ``from_jax_params``, seq 32, batch 2) within 2e-3 of the JAX
  local mode's ``jax.value_and_grad(model.loss)``, the reference's own
  ``check_spmd_model`` bound: at P = 1, and at P = 8 on a
  ``ThreadMesh(c=2, r=2)``.
* Each arch's greedy engine streams equal the JAX engine's at P = 1 on the
  same weights, with a request joining mid-run.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import engine as jax_engine
from repro.configs import paper_models as jax_paper_models
from repro.configs import registry as jax_registry
from repro.configs.base import RunConfig as JaxRunConfig
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.models.factory import build_model as jax_build_model
from repro.plan import make_serve_plan as jax_make_serve_plan
from repro.train import step as jax_train_step
from repro_torch import engine as torch_engine
from repro_torch.configs import paper_models, registry
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.data import pipeline
from repro_torch.dist.comm import ThreadMesh
from repro_torch.models.factory import from_jax_params, to_jax_layout
from repro_torch.plan import make_serve_plan
from repro_torch.train import step as train_step
from test_torch_train_sp import mesh_whole_grads

DENSE = ["h2o-danube-1.8b", "minitron-8b", "deepseek-7b", "stablelm-3b"]
VLM = ["paligemma-3b"]
MOE = ["phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b"]
SSM = ["xlstm-1.3b"]
HYBRID = ["jamba-1.5-large-398b"]
ENCDEC = ["seamless-m4t-large-v2"]
NEW = ["minitron-8b", "deepseek-7b", "stablelm-3b", "gpt-7b"]
PAPER = ["gpt-3b", "gpt-7b", "dit-1b"]
SEQ, BATCH = 32, 2
TOL = 2e-3
ENG = dict(max_slots=2, page_size=4, pages_per_shard=32, max_len=64)
_CTX = {}


def _smoke(name):
    """(JAX, port) smoke configs of ``name``."""
    if name == "gpt-7b":
        return jax_paper_models.smoke_config(), paper_models.smoke_config()
    return jax_registry.get_smoke(name), registry.get_smoke(name)


def _ctx(name):
    if name not in _CTX:
        cfg_j, cfg = _smoke(name)
        model_j = jax_build_model(cfg_j)
        params = model_j.init(jax.random.PRNGKey(0))
        rng = np.random.default_rng(0)
        batch = {n: rng.integers(0, cfg.vocab_size, (BATCH, SEQ),
                                 dtype=np.int32)
                 for n in ("tokens", "labels")}
        rt_j = jax_train_step.make_runtime(
            model_j, JaxRunConfig(c=1, seq_scheme="zigzag"),
            JaxShapeConfig("t", seq_len=SEQ, global_batch=BATCH,
                           kind="train"), mode="local")
        loss_j, grads_j = jax.jit(jax.value_and_grad(
            lambda p: model_j.loss(rt_j, p, batch)))(params)
        tree = jax.tree.map(np.asarray, params)
        _CTX[name] = dict(cfg=cfg, cfg_j=cfg_j, model_j=model_j,
                          params=params, tree=tree, batch=batch,
                          loss_j=float(loss_j), grads_j=grads_j,
                          model=from_jax_params(tree, cfg, "cpu"))
    return _CTX[name]


@pytest.mark.parametrize("arch", DENSE[1:])
def test_arch_configs_equal_jax(arch):
    assert dataclasses.asdict(registry.get(arch)) == dataclasses.asdict(
        jax_registry.get(arch))
    assert dataclasses.asdict(registry.get_smoke(arch)) == \
        dataclasses.asdict(jax_registry.get_smoke(arch))


@pytest.mark.parametrize("name", PAPER)
def test_paper_models_equal_jax(name):
    assert dataclasses.asdict(registry.paper_model(name)) == \
        dataclasses.asdict(jax_registry.paper_model(name))
    assert dataclasses.asdict(paper_models.smoke_config()) == \
        dataclasses.asdict(jax_paper_models.smoke_config())


def test_registry_lists_the_dense_archs_and_refuses_the_rest():
    """The dense archs, the MoE family, xLSTM, the hybrid jamba, the
    encoder-decoder seamless and the VLM paligemma are ported: every
    architecture the JAX registry assigns, each of its family; an unknown
    name raises."""
    ported = DENSE + MOE + SSM + HYBRID + ENCDEC + VLM
    assert sorted(registry.PORTED_ARCHS) == sorted(ported)
    assert sorted(jax_registry.ASSIGNED_ARCHS) == sorted(ported)
    for arch in jax_registry.ASSIGNED_ARCHS:
        assert registry.get(arch).family == (
            "dense" if arch in DENSE else "moe" if arch in MOE
            else "ssm" if arch in SSM else "hybrid" if arch in HYBRID
            else "encdec" if arch in ENCDEC else "vlm")
        assert registry.get_smoke(arch).family == registry.get(arch).family
    with pytest.raises(KeyError):
        registry.get("no-such-arch")
    with pytest.raises(KeyError):
        registry.get_smoke("no-such-arch")


def _leaf_errs(name, grads):
    ctx = _ctx(name)
    names = [n for n, _ in ctx["model"].named_parameters()]
    got = to_jax_layout(dict(zip(names, grads)), ctx["cfg"])
    errs = jax.tree.map(
        lambda a, b: float(np.max(np.abs(a - np.asarray(b, np.float32)))),
        got, ctx["grads_j"])
    return jax.tree.leaves(errs)


@pytest.mark.parametrize("name", NEW)
def test_loss_and_grads_match_jax_at_p1(name):
    ctx = _ctx(name)
    vg_fn, _ = train_step.build_value_and_grad_fn(
        ctx["model"], RunConfig(c=1, seq_scheme="zigzag"),
        ShapeConfig("t", SEQ, BATCH, "train"))
    loss, grads = vg_fn({k: torch.from_numpy(v)
                         for k, v in ctx["batch"].items()})
    assert abs(float(loss) - ctx["loss_j"]) < TOL
    errs = _leaf_errs(name, grads)
    assert len(errs) == len(jax.tree.leaves(ctx["grads_j"])) == 12
    assert np.isfinite(errs).all() and max(errs) < TOL, errs


@pytest.mark.parametrize("name", NEW)
def test_loss_and_grads_match_jax_on_a_thread_mesh(name):
    """P = 8 as ``ThreadMesh(c=2, r=2)``: the global batch in zigzag shard
    order, every gradient leaf assembled whole from the ranks' shards, the
    replicas of a shard the same bits."""
    ctx = _ctx(name)
    perm = pipeline.shard_permutation(SEQ, 8, "zigzag").reshape(-1)
    batch = {k: torch.from_numpy(np.take(v, perm, axis=1))
             for k, v in ctx["batch"].items()}
    losses, grads = mesh_whole_grads(
        ctx["model"], ThreadMesh(2, 2),
        RunConfig(c=2, seq_scheme="zigzag", remat="none"),
        ShapeConfig("t", SEQ, BATCH, "train"), batch)
    assert abs(float(losses[0]) - ctx["loss_j"]) < TOL
    errs = _leaf_errs(name, grads)
    assert np.isfinite(errs).all() and max(errs) < TOL, errs
    assert all(torch.equal(loss, losses[0]) for loss in losses[1:])


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


@pytest.mark.parametrize("name", NEW)
def test_greedy_streams_match_jax_engine(name):
    ctx = _ctx(name)
    cfg = ctx["cfg"]
    kw = dict(decode_batch=ENG["max_slots"], page_size=ENG["page_size"],
              max_len=ENG["max_len"])
    jeng = jax_engine.Engine(
        ctx["model_j"], jax_make_serve_plan(ctx["cfg_j"], arch=name,
                                            n_devices=1, c=1, **kw),
        jax_engine.EngineConfig(**ENG), ctx["params"])
    teng = torch_engine.Engine(
        ctx["model"], make_serve_plan(cfg, arch=name, c=1, **kw),
        torch_engine.EngineConfig(**ENG))
    want = _drive(jeng, _requests(cfg.vocab_size, jax_engine.Request))
    got = _drive(teng, _requests(cfg.vocab_size, torch_engine.Request))
    assert [len(got[u]) for u in ("g", "long", "late")] == [4, 6, 3]
    assert got == want
