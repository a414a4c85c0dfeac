"""repro_torch's training step vs the JAX training step on the same weights.

The smoke h2o-danube-1.8b (f32, 2 layers, window 16) at seq 32, batch 2.
The JAX package makes the parameters (``Model.init``); ``from_jax_params``
carries them into the port, ``to_jax_layout`` carries the port's gradients
and parameters back, and both are compared leaf by leaf.

* The port's ``Model.loss`` on ``SingleComm`` (StarTrail at P = 1, the
  plain B2/B3 versions on CPU tensors) and its autograd gradients against
  the JAX local mode's ``jax.value_and_grad(model.loss)``, within 2e-3 (the
  reference's own ``check_spmd_model`` bound).
* Three ``build_train_step`` steps against three JAX ``build_train_step``
  steps on a one-device mesh (AdamW lr 1e-3, no warmup): loss and
  grad_norm within 2e-3 each step, every parameter leaf within relative L2
  1e-3 after the third. Adam's normalised update can flip sign on a
  near-zero gradient, so single elements are not compared.
* ``adamw.apply`` alone against the JAX ``apply`` (f32 state, clipping
  active, two steps): f32 parameters within 1e-6, bf16 parameters equal or
  one bf16 ulp apart.
* Recompute: ``remat='attn_out'`` and ``'full'`` give the port's
  ``remat='none'`` loss and gradients within f32 rounding (1e-6 relative
  on the loss, 1e-5 on each gradient element), and the JAX local mode's
  under the same policy within 2e-3.
* Gradient accumulation: two ``build_train_step`` steps with
  ``microbatches=2`` (one step with int8 gradient compression on top)
  against the JAX train step with the same settings: the bounds of the
  three-step test.
* ``SyntheticLM`` batches equal the JAX ones bit for bit.
* The ``launch.train`` entry point on the CPU, its unported flags, and a
  run with ``--microbatches`` and ``--ckpt-dir`` restarted from its
  checkpoint.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.configs.base import RunConfig as JaxRunConfig
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.data import pipeline as jax_pipeline
from repro.dist import meshes as jax_meshes
from repro.models.factory import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro.train import step as jax_train_step
from repro_torch.configs import registry
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.data import pipeline
from repro_torch.kernels import flash_attention
from repro_torch.models.factory import from_jax_params, to_jax_layout
from repro_torch.optim import adamw
from repro_torch.plan import make_plan
from repro_torch.train import step as train_step

ARCH = "h2o-danube-1.8b"
SEQ, BATCH = 32, 2
TOL = 2e-3
ADAM = dict(learning_rate=1e-3, warmup_steps=0)
_CTX = {}


def _ctx():
    if not _CTX:
        cfg_j = jax_registry.get_smoke(ARCH)
        model_j = jax_build_model(cfg_j)
        params_j = model_j.init(jax.random.PRNGKey(0))
        rng = np.random.default_rng(0)
        batch = {n: rng.integers(0, cfg_j.vocab_size, (BATCH, SEQ),
                                 dtype=np.int32)
                 for n in ("tokens", "labels")}
        _CTX.update(cfg=registry.get_smoke(ARCH), model_j=model_j,
                    tree=jax.tree.map(np.asarray, params_j), batch=batch)
    return _CTX


def _port_model():
    ctx = _ctx()
    return from_jax_params(ctx["tree"], ctx["cfg"], "cpu")


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_loss_and_grads_match_jax_local_mode():
    ctx = _ctx()
    model_j, cfg = ctx["model_j"], ctx["cfg"]
    shape_j = JaxShapeConfig("test", seq_len=SEQ, global_batch=BATCH,
                             kind="train")
    rt_j = jax_train_step.make_runtime(
        model_j, JaxRunConfig(c=1, seq_scheme="zigzag"), shape_j,
        mode="local")
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: model_j.loss(rt_j, p, ctx["batch"])))(ctx["tree"])

    model = _port_model()
    run_cfg = RunConfig(c=1, seq_scheme="zigzag")
    shape = ShapeConfig("test", SEQ, BATCH, "train")
    vg_fn, rt = train_step.build_value_and_grad_fn(model, run_cfg, shape)
    flash_attention.reset_launches()
    loss, grads = vg_fn(_torch_batch(ctx["batch"]))
    # CPU tensors run the plain versions of B2 and B3: nothing launched
    assert flash_attention.LAUNCHES == {"B1": 0, "B2": 0, "B3": 0}
    assert abs(float(loss) - float(loss_j)) < TOL
    loss_fn, _ = train_step.build_loss_fn(model, run_cfg, shape)
    assert float(loss_fn(_torch_batch(ctx["batch"]))) == float(loss)
    names = [n for n, _ in model.named_parameters()]
    got = to_jax_layout(dict(zip(names, grads)), cfg)
    errs = jax.tree.map(
        lambda a, b: float(np.max(np.abs(a - np.asarray(b, np.float32)))),
        got, grads_j)
    leaves = jax.tree_util.tree_leaves_with_path(errs)
    assert len(leaves) == len(jax.tree.leaves(grads_j)) == 12
    worst = max(leaves, key=lambda kv: kv[1])
    assert np.isfinite(worst[1]) and worst[1] < TOL, worst


def test_three_train_steps_match_jax():
    ctx = _ctx()
    model_j, cfg = ctx["model_j"], ctx["cfg"]
    shape_j = JaxShapeConfig("test", seq_len=SEQ, global_batch=BATCH,
                             kind="train")
    mesh = jax_meshes.local_mesh_for_tests(c=1, r=1, data=1)
    jstep, _ = jax_train_step.build_train_step(
        model_j, mesh, JaxRunConfig(c=1, seq_scheme="zigzag"), shape_j,
        jax_adamw.AdamWConfig(**ADAM))
    params_j = jax.tree.map(jnp.asarray, ctx["tree"])
    opt_j = jax_adamw.init_state(params_j, jax_adamw.AdamWConfig(**ADAM))

    model = _port_model()
    plan = make_plan(cfg, ShapeConfig("test", SEQ, BATCH, "train"), c=1)
    step, sh = plan.build_train_step(model, adamw.AdamWConfig(**ADAM))
    opt = adamw.init_state(sh["params"], adamw.AdamWConfig(**ADAM))
    # SP degree 1: the zigzag layout is the identity permutation
    data = pipeline.SyntheticLM(cfg, plan.shape_config(), seed=3)
    for i in range(3):
        batch = data.get_batch(i)
        params_j, opt_j, m_j = jstep(params_j, opt_j, batch)
        opt, m = step(opt, _torch_batch(batch))
        for key in ("loss", "grad_norm"):
            assert abs(float(m[key]) - float(m_j[key])) < TOL, (i, key)
    got = to_jax_layout(dict(zip(sh["names"], sh["params"])), cfg)
    rel = jax.tree.map(_rel_l2, got, jax.tree.map(np.asarray, params_j))
    worst = max(jax.tree_util.tree_leaves_with_path(rel),
                key=lambda kv: kv[1])
    assert worst[1] < 1e-3, worst
    assert opt["step"] == 3


def _jax_value_and_grad(remat):
    ctx = _ctx()
    shape_j = JaxShapeConfig("test", seq_len=SEQ, global_batch=BATCH,
                             kind="train")
    rt_j = jax_train_step.make_runtime(
        ctx["model_j"], JaxRunConfig(c=1, seq_scheme="zigzag"), shape_j,
        mode="local")
    return jax.jit(jax.value_and_grad(lambda p: ctx["model_j"].loss(
        rt_j, p, ctx["batch"], remat=remat)))(ctx["tree"])


@pytest.mark.parametrize("remat", ["attn_out", "full"])
def test_remat_matches_none_and_jax(remat):
    ctx = _ctx()
    model = _port_model()
    shape = ShapeConfig("test", SEQ, BATCH, "train")
    out = {}
    for r in ("none", remat):
        vg_fn, _ = train_step.build_value_and_grad_fn(
            model, RunConfig(c=1, seq_scheme="zigzag", remat=r), shape)
        out[r] = vg_fn(_torch_batch(ctx["batch"]))
    (loss0, g0), (loss1, g1) = out["none"], out[remat]
    np.testing.assert_allclose(float(loss1), float(loss0), rtol=1e-6)
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    loss_j, grads_j = _jax_value_and_grad(remat)
    assert abs(float(loss1) - float(loss_j)) < TOL
    names = [n for n, _ in model.named_parameters()]
    got = to_jax_layout(dict(zip(names, g1)), ctx["cfg"])
    errs = jax.tree.map(
        lambda a, b: float(np.max(np.abs(a - np.asarray(b, np.float32)))),
        got, grads_j)
    worst = max(jax.tree_util.tree_leaves_with_path(errs),
                key=lambda kv: kv[1])
    assert np.isfinite(worst[1]) and worst[1] < TOL, worst


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_microbatched_train_steps_match_jax(compression):
    ctx = _ctx()
    model_j, cfg = ctx["model_j"], ctx["cfg"]
    shape_j = JaxShapeConfig("test", seq_len=SEQ, global_batch=BATCH,
                             kind="train")
    mesh = jax_meshes.local_mesh_for_tests(c=1, r=1, data=1)
    jstep, _ = jax_train_step.build_train_step(
        model_j, mesh, JaxRunConfig(c=1, seq_scheme="zigzag",
                                    microbatches=2,
                                    grad_compression=compression),
        shape_j, jax_adamw.AdamWConfig(**ADAM))
    params_j = jax.tree.map(jnp.asarray, ctx["tree"])
    opt_j = jax_adamw.init_state(params_j, jax_adamw.AdamWConfig(**ADAM))

    model = _port_model()
    plan = make_plan(cfg, ShapeConfig("test", SEQ, BATCH, "train"), c=1,
                     microbatches=2)
    assert plan.remat == "attn_out"            # the JAX plan's default
    step, sh = train_step.build_train_step(
        model, dataclasses.replace(plan.run_config(),
                                   grad_compression=compression),
        plan.shape_config(), adamw.AdamWConfig(**ADAM))
    opt = adamw.init_state(sh["params"], adamw.AdamWConfig(**ADAM))
    data = pipeline.SyntheticLM(cfg, plan.shape_config(), seed=3)
    # int8 rounding is discontinuous: gradients that differ in their last
    # bits between the two frameworks can land one int8 level apart, and a
    # further Adam step amplifies that, so the int8 run is held for one
    # step (its arithmetic on equal inputs is bit-equal to JAX's:
    # tests/test_torch_checkpoint.py)
    for i in range(2 if compression == "none" else 1):
        batch = data.get_batch(i)
        params_j, opt_j, m_j = jstep(params_j, opt_j, batch)
        opt, m = step(opt, _torch_batch(batch))
        for key in ("loss", "grad_norm"):
            assert abs(float(m[key]) - float(m_j[key])) < TOL, (i, key)
    got = to_jax_layout(dict(zip(sh["names"], sh["params"])), cfg)
    rel = jax.tree.map(_rel_l2, got, jax.tree.map(np.asarray, params_j))
    worst = max(jax.tree_util.tree_leaves_with_path(rel),
                key=lambda kv: kv[1])
    assert worst[1] < 1e-3, worst
    # a batch the microbatches do not divide is refused
    with pytest.raises(ValueError, match="microbatches"):
        make_plan(cfg, ShapeConfig("test", SEQ, 3, "train"), c=1,
                  microbatches=2)


def test_adamw_apply_matches_jax():
    rng = np.random.default_rng(5)
    shapes = [(17, 9), (64,), (3, 5, 7)]
    dts = [np.float32, np.float32, "bfloat16"]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    cfg_kw = dict(learning_rate=1e-2, warmup_steps=3, decay_steps=20,
                  grad_clip=1.0)

    def cast_j(x, dt):
        return jnp.asarray(x).astype(jnp.bfloat16 if dt == "bfloat16"
                                     else jnp.float32)

    def cast_t(x, dt):
        return torch.from_numpy(x).to(torch.bfloat16 if dt == "bfloat16"
                                      else torch.float32)

    p_j = [cast_j(p, dt) for p, dt in zip(params, dts)]
    p_t = [cast_t(p, dt) for p, dt in zip(params, dts)]
    cfg_j = jax_adamw.AdamWConfig(**cfg_kw)
    cfg_t = adamw.AdamWConfig(**cfg_kw)
    s_j = jax_adamw.init_state(p_j, cfg_j)
    s_t = adamw.init_state(p_t, cfg_t)
    for i in range(2):
        # large gradients: the clip at 1.0 is active
        grads = [rng.normal(size=s).astype(np.float32) * 3 for s in shapes]
        p_j, s_j, m_j = jax_adamw.apply(
            p_j, [cast_j(g, dt) for g, dt in zip(grads, dts)], s_j, cfg_j)
        p_t, s_t, m_t = adamw.apply(
            p_t, [cast_t(g, dt) for g, dt in zip(grads, dts)], s_t, cfg_t)
        assert float(m_j["grad_norm"]) > 1.0
        np.testing.assert_allclose(float(m_t["grad_norm"]),
                                   float(m_j["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m_t["lr"]), float(m_j["lr"]),
                                   rtol=1e-7)
    for a, b, dt in zip(p_t, p_j, dts):
        if dt == "bfloat16":
            ua = a.view(torch.int16).numpy().astype(np.int64)
            ub = np.asarray(b).view(np.int16).astype(np.int64)
            assert np.abs(ua - ub).max() <= 1
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=0)
    for a, b in zip(s_t["mu"] + s_t["nu"], s_j["mu"] + s_j["nu"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-5)
    assert s_t["step"] == int(s_j["step"]) == 2


@pytest.mark.parametrize("scheme", ["zigzag", "contiguous"])
@pytest.mark.parametrize("sp", [1, 4])
def test_synthetic_batches_equal_jax(scheme, sp):
    cfg_j = jax_registry.get_smoke(ARCH)
    shape_j = JaxShapeConfig("t", seq_len=64, global_batch=3, kind="train")
    src_j = jax_pipeline.SyntheticLM(cfg_j, shape_j, seed=7,
                                     seq_scheme=scheme, sp_size=sp)
    src_t = pipeline.SyntheticLM(registry.get_smoke(ARCH),
                                 ShapeConfig("t", 64, 3, "train"), seed=7,
                                 seq_scheme=scheme, sp_size=sp)
    for step in (0, 5):
        a, b = src_t.get_batch(step), src_j.get_batch(step)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_launch_train_cpu_and_unported_flags(tmp_path):
    from repro_torch.launch import train

    metrics = tmp_path / "m.jsonl"
    base = ["--arch", ARCH, "--smoke", "--device", "cpu"]
    out = train.main(base + ["--steps", "4", "--seq-len", "32",
                             "--batch", "2", "--metrics", str(metrics)])
    lines = [json.loads(x) for x in metrics.read_text().splitlines()]
    assert [m["step"] for m in lines] == [1, 2, 3, 4]
    assert all(np.isfinite(m["loss"]) and m["loss"] > 0 for m in lines)
    assert out["step"] == 4
    with pytest.raises(NotImplementedError, match="--multi-pod"):
        train.main(base + ["--multi-pod"])
    # --plan reads the JAX layout and refuses what the port cannot honour
    plan_file = tmp_path / "p.json"
    plan_file.write_text(json.dumps({"plan": {
        "arch": ARCH, "seq_len": 32, "n_devices": 1,
        "mesh_kind": "production"}}))
    with pytest.raises(NotImplementedError, match="mesh_kind"):
        train.main(base + ["--plan", str(plan_file)])
    # the flags ported since: Ulysses at P = 1, the registry and the trace
    prom, trace = tmp_path / "m.prom", tmp_path / "t.json"
    out = train.main(base + ["--steps", "1", "--seq-len", "32", "--batch",
                             "2", "--scheme", "ulysses", "--metrics-dump",
                             str(prom), "--trace-out", str(trace)])
    assert out["step"] == 1 and np.isfinite(out["loss"])
    assert "comm_steps_total 1" in prom.read_text()
    assert {e["name"] for e in json.loads(trace.read_text())[
        "traceEvents"]} == {"train/data", "train/step"}


def test_launch_train_microbatches_and_restart(tmp_path, capsys):
    """``--microbatches 2 --ckpt-dir D`` for 4 steps, then again with
    ``--steps 6``: the second run restores step 4 and runs steps 5-6."""
    from repro_torch.launch import train

    ckpt, metrics = tmp_path / "ckpt", tmp_path / "m.jsonl"
    base = ["--arch", ARCH, "--smoke", "--device", "cpu", "--seq-len", "32",
            "--batch", "4", "--microbatches", "2", "--ckpt-dir", str(ckpt),
            "--metrics", str(metrics)]
    train.main(base + ["--steps", "4"])
    assert "microbatches=2" in capsys.readouterr().out
    assert sorted(p.name for p in ckpt.iterdir()) == [
        "opt", "step_00000002", "step_00000004"]
    out = train.main(base + ["--steps", "6"])
    assert "[trainer] restored step 4" in capsys.readouterr().out
    lines = [json.loads(x) for x in metrics.read_text().splitlines()]
    assert [m["step"] for m in lines] == [1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(m["loss"]) for m in lines)
    assert out["step"] == 6


def test_models_are_built_on_the_card_by_default(monkeypatch):
    """``build_model`` and ``from_jax_params`` default to the CUDA card:
    with no card they raise (no silent CPU fallback); asked for the CPU,
    they build there."""
    from repro_torch.models.factory import build_model

    ctx = _ctx()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(ctx["cfg"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_jax_params(ctx["tree"], ctx["cfg"])
    for model in (build_model(ctx["cfg"], "cpu"),
                  from_jax_params(ctx["tree"], ctx["cfg"], "cpu")):
        assert model.device == torch.device("cpu")
