"""repro_torch's attention schemes on a ThreadMesh vs the JAX package: the
paper's baselines (DeepSpeed-Ulysses, Ring Attention) and StarTrail's
chunked ring.

The smoke h2o-danube-1.8b with 8 query / 4 kv heads (``dist_checks.
_gqa_smoke_cfg``: f32, head counts Ulysses can shard at SP 4), the JAX
weights carried across by ``from_jax_params``, numpy batches from a seed.

* Ulysses and the ring at SP 4 with 2 data replicas: loss and reduced
  gradients against the JAX local mode's ``jax.value_and_grad(model.loss)``
  within 2e-3 (``check_spmd_model``'s bound).
* ``check_scheme_crosscheck``: StarTrail (C = 2) and Ulysses against the
  ring through ``make_plan`` plans, within 2e-3.
* Ulysses at SP 8 with 4 kv heads falls back per layer to StarTrail: the
  same bits as StarTrail, and no all-to-all byte in the ledger.
* ``check_ulysses_rejected``: one kv head is refused at the plan and in
  the attention itself, with the JAX wording.
* Ulysses' all-to-all gathers the sequence in linear SP-rank order: its
  output equals plain attention of the whole sequence at P = 4 and 8,
  C = 1 and 2, both placements.
* ``kernels.ops.flash_attention`` (B1 forward, B3 backward through
  ``dispatch``) against ``jax.vjp`` of ``ref.block_attention`` and of the
  JAX ``ops.flash_attention`` (Pallas kernels in interpret mode), 2e-5.
* ``check_pipelined_bitexact``'s chunk half: comm_chunks 2 and 4 give the
  loss and every gradient of the unsplit ring bit for bit (bf16 inputs),
  with the same ledger bytes; also with a window and ``block_skip``. A
  chunk count that does not divide raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.configs.base import RunConfig as JaxRunConfig
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models.factory import build_model as jax_build_model
from repro.plan import cost as jax_cost
from repro.train import step as jax_train_step
from repro_torch.configs import registry
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.core import startrail as st
from repro_torch.core import ulysses
from repro_torch.data import pipeline
from repro_torch.dist.comm import ThreadMesh
from repro_torch.kernels import ops, ref
from repro_torch.models.factory import from_jax_params, to_jax_layout
from repro_torch.plan import cost, make_plan
from repro_torch.train import step as train_step
from test_torch_train_sp import mesh_whole_grads

ARCH = "h2o-danube-1.8b"
SEQ, BATCH = 32, 2
TOL = 2e-3
SP_AXES = ("sp_grp", "sp_ring", "sp_team")
_CTX = {}


def _gqa(cfg):
    return dataclasses.replace(cfg, num_heads=8, num_kv_heads=4,
                               param_dtype="float32")


def _ctx():
    if not _CTX:
        cfg_j = _gqa(jax_registry.get_smoke(ARCH))
        model_j = jax_build_model(cfg_j)
        params_j = model_j.init(jax.random.PRNGKey(0))
        rng = np.random.default_rng(0)
        batch = {n: rng.integers(0, cfg_j.vocab_size, (BATCH, SEQ),
                                 dtype=np.int32)
                 for n in ("tokens", "labels")}
        _CTX.update(cfg=_gqa(registry.get_smoke(ARCH)), model_j=model_j,
                    tree=jax.tree.map(np.asarray, params_j), batch=batch)
    return _CTX


def _model():
    return from_jax_params(_ctx()["tree"], _ctx()["cfg"], "cpu")


def _sharded(batch, sp):
    perm = pipeline.shard_permutation(batch["tokens"].shape[1], sp,
                                      "zigzag").reshape(-1)
    return {k: torch.from_numpy(np.take(v, perm, axis=1))
            for k, v in batch.items()}


def _mesh_vg(model, mesh, run_cfg, shape, batch):
    """Every rank's (loss, reduced grads, ledger bytes), in thread order."""
    def rank_fn(comm):
        vg_fn, rt = train_step.build_value_and_grad_fn(model, run_cfg, shape,
                                                       comm)
        loss, grads = vg_fn(train_step.shard_batch(batch, rt))
        return loss, grads, comm.ledger.snapshot()

    return mesh.run(rank_fn, timeout=120)


def _max_err(grads_a, grads_b):
    return max(float((a - b).abs().max()) for a, b in zip(grads_a, grads_b))


@pytest.mark.parametrize("scheme", ["ulysses", "ring"])
def test_baselines_match_jax_local_mode(scheme):
    ctx = _ctx()
    shape_j = JaxShapeConfig("test", seq_len=SEQ, global_batch=BATCH,
                             kind="train")
    rt_j = jax_train_step.make_runtime(
        ctx["model_j"], JaxRunConfig(c=1, seq_scheme="zigzag"), shape_j,
        mode="local")
    loss_j, grads_j = jax.jit(jax.value_and_grad(lambda p: ctx[
        "model_j"].loss(rt_j, p, ctx["batch"], remat="none")))(ctx["tree"])
    model = _model()
    mesh = ThreadMesh(1, 4, data=2)
    losses, grads = mesh_whole_grads(
        model, mesh, RunConfig(c=1, attention_scheme=scheme, remat="none"),
        ShapeConfig("test", SEQ, BATCH, "train"), _sharded(ctx["batch"], 4))
    ledger = mesh.ledgers[0].snapshot()
    assert abs(float(losses[0]) - float(loss_j)) < TOL
    names = [n for n, _ in model.named_parameters()]
    got = to_jax_layout(dict(zip(names, grads)), ctx["cfg"])
    errs = jax.tree_util.tree_leaves_with_path(jax.tree.map(
        lambda a, b: float(np.max(np.abs(a - np.asarray(b, np.float32)))),
        got, grads_j))
    assert len(errs) == 12
    worst = max(errs, key=lambda kv: kv[1])
    assert np.isfinite(worst[1]) and worst[1] < TOL, worst
    assert all(torch.equal(loss, losses[0]) for loss in losses[1:])
    # the scheme's collectives, and nothing of the other's
    used, unused = (("all-to-all", "collective-permute")
                    if scheme == "ulysses"
                    else ("collective-permute", "all-to-all"))
    for ph in ("forward", "backward"):
        assert ledger[ph][used] > 0 and ledger[ph][unused] == 0, ledger


def test_scheme_crosscheck():
    """``check_scheme_crosscheck``: seq 64, batch 4, 8 ranks, data 2."""
    cfg = _ctx()["cfg"]
    model = _model()
    seq, batch = 64, 4
    shape = ShapeConfig("test", seq, batch, "train")
    rng = np.random.default_rng(1)
    batch_g = {n: rng.integers(0, cfg.vocab_size, (batch, seq),
                               dtype=np.int32)
               for n in ("tokens", "labels")}
    results = {}
    for scheme, c in (("ring", 1), ("startrail", 2), ("ulysses", 1)):
        plan = make_plan(cfg, shape, n_devices=8, data=2, scheme=scheme, c=c)
        vg = train_step.build_mesh_value_and_grad_fn(
            model, plan.run_config(), shape, plan.build_mesh(), timeout=120)
        results[scheme] = vg(_sharded(batch_g, plan.sp_size))
    l_ring, g_ring = results["ring"]
    for scheme in ("startrail", "ulysses"):
        loss, grads = results[scheme]
        assert abs(float(loss) - float(l_ring)) < TOL, scheme
        assert _max_err(grads, g_ring) < TOL, scheme


def test_ulysses_falls_back_per_layer_to_startrail():
    """SP 8 with 4 kv heads: no layer can shard its kv heads, so every
    layer runs StarTrail: the same bits, and no all-to-all."""
    ctx = _ctx()
    model = _model()
    shape = ShapeConfig("test", SEQ, BATCH, "train")
    batch = _sharded(ctx["batch"], 8)
    (l_u, g_u, led_u), (l_s, g_s, led_s) = (
        _mesh_vg(model, ThreadMesh(2, 2), RunConfig(
            c=2, attention_scheme=scheme, remat="none"), shape, batch)[0]
        for scheme in ("ulysses", "startrail"))
    assert torch.equal(l_u, l_s)
    assert all(torch.equal(a, b) for a, b in zip(g_u, g_s))
    assert led_u == led_s and led_u["forward"]["all-to-all"] == 0


def test_ulysses_rejected_for_one_kv_head():
    """``check_ulysses_rejected``: at the plan and in the attention."""
    cfg = dataclasses.replace(registry.get_smoke(ARCH), num_kv_heads=1)
    cfg_j = dataclasses.replace(jax_registry.get_smoke(ARCH), num_kv_heads=1)
    with pytest.raises(ValueError, match="head counts divisible") as e:
        cost.check_scheme(cfg, 8, "ulysses")
    with pytest.raises(ValueError) as e_j:
        jax_cost.check_scheme(cfg_j, 8, "ulysses")
    assert str(e.value) == str(e_j.value)
    shape = ShapeConfig("test", 64, 4, "train")
    with pytest.raises(ValueError, match="head counts divisible"):
        make_plan(cfg, shape, n_devices=8, scheme="ulysses", c=1)
    assert not cost.ulysses_supported(cfg, 8)
    cfg_st = st.StarTrailConfig(seq_len=32, seq_scheme="contiguous")

    def rank_fn(comm):
        q = torch.zeros((1, 4, 4, 8))
        kv = torch.zeros((1, 4, 1, 8))
        return ulysses.ulysses_attention(q, kv, kv, cfg_st, comm)

    with pytest.raises(ValueError, match="head counts divisible"):
        ThreadMesh(1, 8).run(rank_fn, timeout=60)


@pytest.mark.parametrize("c,r,placement", [
    (1, 4, "team_inner"), (2, 1, "team_inner"), (2, 1, "ring_inner"),
    (1, 8, "team_inner"), (2, 2, "team_inner"), (2, 2, "ring_inner")])
def test_ulysses_all_to_all_rank_order(c, r, placement):
    """Each rank's Ulysses output equals its shard of plain attention over
    the whole sequence: the all-to-all tiles in linear SP-rank order."""
    p, n, hq, hkv, d = c * c * r, 64, 8, 8, 8
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, n, h, d)).astype(
        np.float32)) for h in (hq, hkv, hkv))
    cfg = st.StarTrailConfig(seq_len=n, seq_scheme="zigzag", window=24)
    pos = torch.arange(n, dtype=torch.int32)
    want, _ = ref.block_attention(q, k, v, pos, pos, window=24)

    def rank_fn(comm):
        rank = ((comm.axis_index("sp_grp") * r + comm.axis_index("sp_ring"))
                * c + comm.axis_index("sp_team"))
        idx = st.shard_positions(rank, n, p, "zigzag").long()
        o = ulysses.ulysses_attention(q[:, idx], k[:, idx], v[:, idx], cfg,
                                      comm)
        return float((o - want[:, idx]).abs().max())

    errs = ThreadMesh(c, r, placement=placement).run(rank_fn, timeout=60)
    assert max(errs) < 2e-5, errs


def _zigzag_concat(n, p):
    return np.concatenate([st.shard_positions(i, n, p, "zigzag").numpy()
                           for i in range(p)]).astype(np.int32)


@pytest.mark.parametrize("window", [None, 24])
def test_flash_attention_function_matches_jax_vjp(window):
    """B1 forward / B3 backward through ``FlashAttention`` against
    ``jax.vjp`` of ``ref.block_attention`` and of the JAX
    ``ops.flash_attention`` (Pallas, interpret mode), 2e-5: Ulysses'
    unsorted positions (zigzag shards concatenated)."""
    rng = np.random.default_rng(3)
    b, s, hq, hkv, d = 1, 64, 4, 2, 16
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32)
               for h in (hq, hkv, hkv))
    do = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    pos = _zigzag_concat(s, 4)

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tp = torch.from_numpy(pos)
    o = ops.flash_attention(tq, tk, tv, tp, tp, window=window)
    o.backward(torch.from_numpy(do))
    got = [o.detach().numpy()] + [t.grad.numpy() for t in (tq, tk, tv)]

    jp = jnp.asarray(pos)
    fns = {
        "ref": lambda q, k, v: jax_ref.block_attention(
            q, k, v, jp, jp, causal=True, window=window)[0],
        "pallas": lambda q, k, v: jax_ops.flash_attention(
            q, k, v, jp, jp, True, window, None),
    }
    for name, fn in fns.items():
        o_j, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
        want = [np.asarray(o_j)] + [np.asarray(g) for g in
                                    vjp(jnp.asarray(do))]
        for what, a, w in zip(("o", "dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(a, w, atol=2e-5, rtol=2e-5,
                                       err_msg=f"{name} {what}")


def _run_ring(comm_chunks, *, seq_scheme="zigzag", window=None,
              block_skip=False, c=2, r=2, seq=64, batch=2, hq=4, hkv=2, d=8):
    """``check_pipelined_bitexact``'s run at one ``comm_chunks``: every
    rank's local loss, its gradients and its ledger, from bf16 inputs."""
    cfg = st.StarTrailConfig(
        seq_len=seq, seq_scheme=seq_scheme, window=window,
        block_skip=block_skip, comm_chunks=comm_chunks)
    rng = np.random.default_rng(4)
    full = [torch.from_numpy(rng.normal(size=(batch, seq, h, d)).astype(
        np.float32)).bfloat16() for h in (hq, hkv, hkv)]
    p = c * c * r

    def rank_fn(comm):
        rank = ((comm.axis_index("sp_grp") * r + comm.axis_index("sp_ring"))
                * c + comm.axis_index("sp_team"))
        idx = st.shard_positions(rank, seq, p, seq_scheme).long()
        q, k, v = (x[:, idx].clone().requires_grad_() for x in full)
        loss = (st.startrail_attention(q, k, v, cfg, comm).float()
                ** 2).sum()
        loss.backward()
        return loss.detach(), [x.grad for x in (q, k, v)], \
            comm.ledger.snapshot()

    return ThreadMesh(c, r).run(rank_fn, timeout=60)


def test_chunked_ring_bitexact():
    base = _run_ring(1)
    cases = [2, 4]
    runs = {case: _run_ring(case) for case in cases}
    runs["window"] = (_run_ring(1, seq_scheme="contiguous", window=16,
                                block_skip=True),
                      _run_ring(2, seq_scheme="contiguous", window=16,
                                block_skip=True))
    for case in cases + ["window"]:
        ref_run, run = (runs[case] if case == "window"
                        else (base, runs[case]))
        for (l0, g0, led0), (l1, g1, led1) in zip(ref_run, run):
            assert torch.equal(l0, l1), case
            for name, a, b in zip("qkv", g0, g1):
                assert a.dtype == torch.bfloat16
                assert torch.equal(a, b), (case, f"d{name}")
            assert led0 == led1, case
    led = base[0][2]
    assert all(led[ph]["collective-permute"] > 0
               for ph in ("forward", "backward"))
    with pytest.raises(ValueError, match="comm_chunks=3 must divide"):
        _run_ring(3)
