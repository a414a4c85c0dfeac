"""repro_torch's checkpoints, int8 gradient compression and token-file
source against the JAX package's.

* ``optim.grad``: ``int8_roundtrip`` and ``error_feedback_compress`` give
  the JAX functions' bits on the same f32 and bf16 inputs (ties included:
  both round half to even); stochastic rounding picks a neighbouring level
  and is unbiased within 5 standard deviations of the mean of its draws.
* ``dist.checkpoint``: the JAX on-disk format both ways. The port's
  checkpoint of the smoke model in bf16 (parameters as the JAX tree, the
  AdamW state as ``{"mu", "nu", "step"}``) restores through
  ``repro.dist.checkpoint.restore`` to identical arrays, and the JAX
  package's restores in the port; ``.tmp`` staging directories are
  invisible and ``latest_common_step`` skips a torn step.
* A JAX trainer run of 2 steps, resumed by the port's trainer from its
  checkpoint, gives the JAX run's step-3 loss within 2e-3.
* ``data.pipeline.TokenFile`` batches equal the JAX ``TokenFile``'s.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.data import pipeline as jax_pipeline
from repro.dist import checkpoint as jax_ckpt
from repro.models.factory import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro.optim import grad as jax_grad
from repro.plan.plan import make_plan as jax_make_plan
from repro.train import trainer as jax_trainer
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import pipeline
from repro_torch.dist import checkpoint
from repro_torch.models.factory import build_model, jax_tree
from repro_torch.optim import adamw
from repro_torch.optim import grad
from repro_torch.plan import make_plan
from repro_torch.train import trainer

ARCH = "h2o-danube-1.8b"
ADAM = dict(learning_rate=1e-3, warmup_steps=0)


def _bits(x) -> np.ndarray:
    """The raw bits of a torch tensor or a (JAX / numpy) array."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous().reshape(-1)
        return x.view({2: torch.int16, 4: torch.int32}[x.element_size()]
                      ).numpy().view(np.uint8)
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _grads(rng):
    g = [rng.normal(size=(33, 7)).astype(np.float32) * 1e-3,
         rng.normal(size=(129,)).astype(np.float32),
         # max |x| = 127: scale 1, so the halves are exact ties
         np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3e-3],
                  np.float32)]
    return g, ["float32", "bfloat16", "float32"]


def _cast(x, dt, lib):
    if lib == "jax":
        return jnp.asarray(x).astype(jnp.bfloat16 if dt == "bfloat16"
                                     else jnp.float32)
    return torch.from_numpy(x).to(torch.bfloat16 if dt == "bfloat16"
                                  else torch.float32)


def test_int8_roundtrip_and_error_feedback_equal_jax():
    rng = np.random.default_rng(0)
    gs, dts = _grads(rng)
    res = [rng.normal(size=g.shape).astype(np.float32) * 1e-2 for g in gs]
    g_t = [_cast(g, dt, "torch") for g, dt in zip(gs, dts)]
    g_j = [_cast(g, dt, "jax") for g, dt in zip(gs, dts)]
    for a, b in zip(grad.int8_roundtrip(g_t), jax_grad.int8_roundtrip(g_j)):
        assert a.dtype == {jnp.bfloat16: torch.bfloat16,
                           jnp.float32: torch.float32}[b.dtype.type]
        assert np.array_equal(_bits(a), _bits(b))
    dec_t, res_t = grad.error_feedback_compress(
        g_t, [torch.from_numpy(r) for r in res])
    dec_j, res_j = jax_grad.error_feedback_compress(
        g_j, [jnp.asarray(r) for r in res])
    for a, b in zip(dec_t + res_t, dec_j + res_j):
        assert np.array_equal(_bits(a), _bits(b))
    q, scale = grad.quantize_int8(g_t[2])
    assert float(scale) == 1.0
    assert q.tolist() == [127, 0, 2, 2, 0, -2, -2, 0]   # half to even
    z = grad.zeros_like_residual(g_t)
    assert [tuple(t.shape) for t in z] == [g.shape for g in gs]
    assert all(t.dtype == torch.float32 and not t.any() for t in z)


def test_stochastic_rounding_is_unbiased():
    """N draws of each element (one call on N stacked copies: the
    per-tensor scale is that of x). Each draw is floor or ceil of x/scale,
    so its error is within one scale and its variance at most scale^2/4;
    the mean of N draws is within 5 * scale / (2 sqrt N) of x."""
    n = 4000
    x = torch.from_numpy(np.random.default_rng(1).normal(size=64).astype(
        np.float32))
    gen = torch.Generator().manual_seed(0)
    q, scale = grad.quantize_int8(x.expand(n, -1), generator=gen)
    deq = grad.dequantize_int8(q, scale)
    assert float(scale) == float(x.abs().max() / 127.0)
    assert bool(((deq - x).abs() < scale * (1 + 1e-6)).all())
    bound = 5 * float(scale) / (2 * n ** 0.5)
    assert float((deq.mean(0) - x).abs().max()) < bound
    # both neighbours are drawn, and the generator decides which
    assert (deq != deq[0]).any()
    q2, _ = grad.quantize_int8(x.expand(n, -1),
                               generator=torch.Generator().manual_seed(0))
    assert torch.equal(q, q2)


def _bf16_cfgs():
    cfg_j = dataclasses.replace(jax_registry.get_smoke(ARCH),
                                param_dtype="bfloat16")
    cfg_t = dataclasses.replace(registry.get_smoke(ARCH),
                                param_dtype="bfloat16")
    return cfg_j, cfg_t


def _port_state(cfg, seed):
    model = build_model(cfg, "cpu", seed=seed)
    names = [n for n, _ in model.named_parameters()]
    rng = np.random.default_rng(seed)
    opt = {k: [torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
               for p in model.parameters()] for k in ("mu", "nu")}
    opt["step"] = 7
    return model, names, opt


def test_port_checkpoint_restores_in_jax(tmp_path):
    cfg_j, cfg_t = _bf16_cfgs()
    model, names, opt = _port_state(cfg_t, seed=2)
    params = jax_tree(dict(model.named_parameters()), cfg_t)
    opt_tree = trainer.opt_tree(opt, names, cfg_t)
    checkpoint.save(tmp_path, 7, params)
    checkpoint.save(tmp_path / "opt", 7, opt_tree, blocking=False).join()

    params_j = jax_build_model(cfg_j).init(jax.random.PRNGKey(0))
    like = jax.tree.map(np.asarray, params_j)
    got = jax_ckpt.restore(tmp_path, 7, like)
    want = checkpoint.leaves(params)
    assert len(jax.tree.leaves(got)) == len(want) == 12
    for a, b in zip(jax.tree.leaves(got), want):
        assert a.dtype == jnp.bfloat16 and np.array_equal(_bits(a), _bits(b))
    opt_like = jax_adamw.init_state(params_j, jax_adamw.AdamWConfig())
    got_opt = jax_ckpt.restore(tmp_path / "opt", 7, opt_like)
    assert int(got_opt["step"]) == 7 and got_opt["step"].dtype == jnp.int32
    for a, b in zip(jax.tree.leaves(got_opt), checkpoint.leaves(opt_tree)):
        assert np.array_equal(_bits(a), _bits(b))


def test_jax_checkpoint_restores_in_port(tmp_path):
    cfg_j, cfg_t = _bf16_cfgs()
    params_j = jax_build_model(cfg_j).init(jax.random.PRNGKey(3))
    opt_j = jax_adamw.init_state(params_j, jax_adamw.AdamWConfig())
    opt_j["mu"] = jax.tree.map(lambda p: p.astype(jnp.float32) * 0.5,
                               params_j)
    opt_j["step"] = jnp.int32(5)
    jax_ckpt.save(tmp_path, 5, params_j)
    jax_ckpt.save(tmp_path / "opt", 5, opt_j)

    model, names, opt = _port_state(cfg_t, seed=4)
    assert trainer.restore_latest(tmp_path, model, names, opt) == 5
    got = jax_tree(dict(model.named_parameters()), cfg_t)
    for a, b in zip(checkpoint.leaves(got), jax.tree.leaves(params_j)):
        assert a.dtype == torch.bfloat16
        assert np.array_equal(_bits(a), _bits(b))
    got_opt = trainer.opt_tree(opt, names, cfg_t)
    assert opt["step"] == 5
    for a, b in zip(checkpoint.leaves(got_opt), jax.tree.leaves(opt_j)):
        assert np.array_equal(_bits(a), _bits(b))
    # a tree of another shape or dtype is refused
    with pytest.raises(ValueError, match="dtype"):
        checkpoint.restore(tmp_path, 5, jax_tree(
            {n: p.float() for n, p in model.named_parameters()}, cfg_t))


def test_torn_and_staging_steps_are_invisible(tmp_path):
    tree = {"b": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "a": [torch.ones(4, dtype=torch.bfloat16), torch.zeros(())]}
    for step in (2, 4):
        checkpoint.save(tmp_path, step, tree)
    checkpoint.save(tmp_path / "opt", 2, tree)
    # a writer that died mid-step 4 of the optimizer tree
    (tmp_path / "opt" / "step_00000004.tmp").mkdir()
    assert checkpoint.completed_steps(tmp_path / "opt") == {2}
    assert checkpoint.latest_step(tmp_path) == 4
    assert checkpoint.latest_common_step(tmp_path, tmp_path / "opt") == 2
    assert jax_ckpt.latest_common_step(tmp_path, tmp_path / "opt") == 2
    assert checkpoint.latest_common_step(tmp_path / "none") is None
    back = checkpoint.restore(tmp_path, 4, tree)
    assert list(back) == ["b", "a"]
    for a, b in zip(checkpoint.leaves(back), checkpoint.leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    manifest = json.loads(
        (tmp_path / "step_00000004" / "manifest.json").read_text())
    assert [e["dtype"] for e in manifest["leaves"]] == [
        "bfloat16", "float32", "int32"]


def test_port_trainer_resumes_a_jax_run(tmp_path):
    """The JAX trainer runs 3 steps and checkpoints at step 2; the port's
    trainer, on a model initialised otherwise, restores step 2 and runs
    step 3 to the JAX run's loss."""
    cfg_j = jax_registry.get_smoke(ARCH)
    shape = dict(seq_len=32, global_batch=2, kind="train")
    plan_j = jax_make_plan(cfg_j, JaxShapeConfig("test", **shape),
                           arch=ARCH, n_devices=1, c=1)
    ckpt, m_j, m_t = (tmp_path / n for n in ("ckpt", "j.jsonl", "t.jsonl"))
    jax_trainer.train(
        jax_build_model(cfg_j), plan_j, jax_adamw.AdamWConfig(**ADAM),
        jax_trainer.TrainerConfig(num_steps=3, ckpt_every=2,
                                  ckpt_dir=str(ckpt), metrics_path=str(m_j)))
    assert checkpoint.latest_common_step(ckpt, ckpt / "opt") == 2

    cfg = registry.get_smoke(ARCH)
    plan = make_plan(cfg, ShapeConfig("test", **shape), arch=ARCH, c=1)
    out = trainer.train(build_model(cfg, "cpu", seed=9), plan,
                        adamw.AdamWConfig(**ADAM),
                        trainer.TrainerConfig(num_steps=3,
                                              ckpt_dir=str(ckpt),
                                              metrics_path=str(m_t)),
                        device="cpu")
    want = [json.loads(x) for x in m_j.read_text().splitlines()]
    got = [json.loads(x) for x in m_t.read_text().splitlines()]
    assert [m["step"] for m in got] == [3] and out["step"] == 3
    assert abs(got[0]["loss"] - want[2]["loss"]) < 2e-3


@pytest.mark.parametrize("dtype,scheme,sp", [
    (np.uint16, "zigzag", 2), (np.uint32, "contiguous", 1)])
def test_token_file_batches_equal_jax(tmp_path, dtype, scheme, sp):
    path = tmp_path / "tokens.bin"
    rng = np.random.default_rng(4)
    rng.integers(0, 32000, size=3 * 2 * 65 + 17).astype(dtype).tofile(path)
    src_t = pipeline.TokenFile(str(path), registry.get_smoke(ARCH),
                               ShapeConfig("t", 64, 2, "train"),
                               dtype=dtype, seq_scheme=scheme, sp_size=sp)
    src_j = jax_pipeline.TokenFile(str(path), jax_registry.get_smoke(ARCH),
                                   JaxShapeConfig("t", seq_len=64,
                                                  global_batch=2,
                                                  kind="train"),
                                   dtype=dtype, seq_scheme=scheme,
                                   sp_size=sp)
    assert src_t.num_batches == src_j.num_batches == 3
    for step in (0, 2, 4):
        a, b = src_t.get_batch(step), src_j.get_batch(step)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="too small"):
        pipeline.TokenFile(str(path), registry.get_smoke(ARCH),
                           ShapeConfig("t", 512, 2, "train"), dtype=dtype)
