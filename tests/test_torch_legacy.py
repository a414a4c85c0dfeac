"""repro_torch's static-batch serve path (``launch.serve --legacy``) vs the
JAX package.

* The plain version of kernel B5 (``kernels.ragged_prefill``) against the
  Pallas ``ragged_prefill_fwd`` in interpret mode: 2e-5 in f32 on live
  rows, dead rows exactly o = 0, lse = -1e30 (closeness, not bit-identity:
  the JAX single-tile bit-identity cases fail on this jax).
* The legacy loop's greedy tokens against the JAX steps it mirrors (smoke
  h2o-danube-1.8b, f32 weights carried over with ``from_jax_params``):
  ``build_prefill_step``, the cache copied into a capacity-sized one as
  ``_legacy_main`` does, then the JAX contiguous-cache decode island at
  each step's true cache length. (``_legacy_main`` itself compiles its
  decode step once with ``cache_len = capacity - 1`` for every step, so its
  tokens are not those of greedy decoding; the port decodes at the true
  lengths.)
* The contiguous decode on a two-rank ``ThreadMesh`` (the cache split over
  the ranks, the token written on its owner) against one rank.
* ``--legacy`` on the plan's ``ThreadMesh`` ranks: at P = 4 (c = 2, r = 1)
  and at (c, data) = (2, 2), the batch split over the replicas (4 rows)
  or served whole by each (3 rows), the tokens of the JAX islands on the
  same mesh (one child process with 8 forced host devices, started by the
  first of those tests), the capacity padded to the SP multiple.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import registry as jax_registry
from repro.configs.base import ShapeConfig as JaxShape
from repro.kernels import ragged_prefill as jax_ragged
from repro.models.factory import build_model as jax_build_model
from repro.plan import make_serve_plan as jax_make_serve_plan
from repro.serve import kv_cache as jax_kv_cache
from repro.serve import step as jax_serve_step
from repro_torch.configs import registry
from repro_torch.core import startrail as st
from repro_torch.dist.comm import SingleComm, ThreadMesh
from repro_torch.kernels import ragged_prefill
from repro_torch.launch import serve
from repro_torch.models.factory import (build_model, from_jax_params,
                                        shard_params)
from repro_torch.models.runtime import Runtime
from repro_torch.plan import make_serve_plan
from repro_torch.serve import kv_cache
from repro_torch.serve import step as serve_step
from test_torch_gpu import RAGGED_CASES, _assert_partials, _ragged_inputs, _t

ARCH = "h2o-danube-1.8b"


@pytest.mark.parametrize("case", sorted(RAGGED_CASES))
def test_ragged_prefill_plain_matches_jax(case):
    B, Sq, Sk, Hq, Hkv, D, window, kind = RAGGED_CASES[case]
    arrs = _ragged_inputs(B, Sq, Sk, Hq, Hkv, D, kind)
    o_j, lse_j = jax_ragged.ragged_prefill_fwd(
        *(jnp.asarray(x) for x in arrs), causal=True, window=window,
        interpret=True)
    ragged_prefill.reset_launches()
    o_t, lse_t = ragged_prefill.ragged_prefill_fwd(*(_t(x) for x in arrs),
                                                   window=window)
    assert ragged_prefill.LAUNCHES == {"B5": 0}
    _assert_partials(o_t.numpy(), lse_t.numpy(), o_j, lse_j)
    if kind == "lengths" and B > 2:
        assert (lse_t[2].numpy() <= -1e30 / 2).all()   # the zero-length row


def _jax_legacy_steps(cfg, params, plan, tokens, gen):
    """The JAX steps of ``_legacy_main`` at the true cache lengths: the
    capacity padded to the SP multiple, the prompt's K/V copied into its
    prefix and recurrent states carried over (its ``merge``)."""
    model = jax_build_model(cfg)
    mesh, run_cfg = plan.build_mesh(), plan.run_config()
    B, prompt_len = tokens.shape
    sp = plan.sp_size
    capacity = -(-(prompt_len + gen) // sp) * sp
    jprefill, _ = jax_serve_step.build_prefill_step(
        model, mesh, run_cfg, JaxShape("serve", prompt_len, B, "prefill"))
    tok, cache_p = jprefill(params, {"tokens": jnp.asarray(tokens,
                                                           jnp.int32)})
    cache = jax.tree.map(np.array, jax_kv_cache.init_cache(cfg, B,
                                                           capacity))
    for sub, leaves in cache["stack"].items():
        for n, leaf in leaves.items():
            src = np.asarray(cache_p["stack"][sub][n])
            if leaf.ndim >= 3 and leaf.shape[2] == capacity:
                leaf[:, :, :prompt_len] = src
            else:
                leaves[n] = src
    _, info = jax_serve_step.build_decode_step(
        model, mesh, run_cfg, JaxShape("serve", capacity, B, "decode"))
    decode = jax.jit(jax.shard_map(
        lambda p, c, t, cl: jax_serve_step.lm_decode_step(
            info["rt"], p, c, t, cfg, cl),
        mesh=mesh, in_specs=(info["param_specs"], info["cache_specs"],
                             info["tok_spec"], P(info["tok_spec"][0])),
        out_specs=(info["tok_spec"], info["cache_specs"]), check_vma=False))
    out = [np.asarray(tok)]
    for i in range(gen - 1):
        tok, cache = decode(params, cache, tok,
                            np.full((B,), prompt_len + i, np.int32))
        out.append(np.asarray(tok))
    return np.concatenate(out, axis=1)


def test_legacy_tokens_match_jax_steps():
    cfg = jax_registry.get_smoke(ARCH)
    plan_j = jax_make_serve_plan(cfg, arch=ARCH, n_devices=1, c=1)
    params = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    B, prompt_len, gen = 3, 11, 5
    tokens = rng.integers(0, cfg.vocab_size, (B, prompt_len))
    want = _jax_legacy_steps(cfg, params, plan_j, tokens, gen)
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg, "cpu")
    plan = make_serve_plan(cfg, arch=ARCH, c=1)
    got = serve.legacy_generate(model, plan, torch.from_numpy(tokens), gen)
    assert got.shape == (B, gen)
    np.testing.assert_array_equal(got.numpy(), want)


def test_contiguous_decode_on_two_ranks_matches_one():
    """``lm_decode_step`` on the contiguous cache: two ranks (each holding
    half the capacity, the new token written on its owner, the partials
    merged) against one rank, rows at different lengths."""
    cfg = registry.get_smoke(ARCH)
    model = build_model(cfg, "cpu", seed=0)
    B, capacity = 3, 16
    cache_len = torch.tensor([5, 8, 14], dtype=torch.int32)
    rng = np.random.default_rng(2)
    full = kv_cache.init_cache(cfg, B, capacity, "cpu")
    for n in ("k", "v"):
        full[n].copy_(torch.from_numpy(rng.normal(size=full[n].shape)
                                       .astype(np.float32)))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)))

    def run(comm):
        rt = Runtime(comm=comm, st_cfg=st.StarTrailConfig(
            seq_len=capacity, seq_scheme="contiguous", window=cfg.window,
            block_impl="cuda"))
        s, r = capacity // rt.sp_size(), rt.sp_rank()
        cache = {n: full[n][:, :, r * s:(r + 1) * s].clone()
                 for n in ("k", "v")}
        with torch.no_grad():
            hidden = serve_step.lm_decode_step(
                rt, shard_params(model, comm), cache, tokens, cfg, cache_len,
                return_hidden=True)
        return hidden, cache

    h1, c1 = run(SingleComm())
    (h_a, c_a), (h_b, c_b) = ThreadMesh(1, 2).run(run, timeout=120)
    for h in (h_a, h_b):
        np.testing.assert_allclose(h.numpy(), h1.numpy(), atol=2e-5,
                                   rtol=2e-5)
    for n in ("k", "v"):
        np.testing.assert_allclose(
            torch.cat([c_a[n], c_b[n]], dim=2).numpy(), c1[n].numpy(),
            atol=2e-5, rtol=2e-5)
        # the new tokens landed at each row's cache_len
        changed = (c1[n] != full[n]).any(dim=(0, 3, 4))
        want = torch.zeros_like(changed)
        want[torch.arange(B), cache_len.long()] = True
        assert torch.equal(changed, want)


def test_launch_serve_legacy_cpu():
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--legacy", "--batch", "2", "--prompt-len", "6",
                      "--gen", "3"])
    assert tuple(out.shape) == (2, 3)
    assert ((out >= 0) & (out < registry.get_smoke(ARCH).vocab_size)).all()


# ---------------------------------------------------------------------------
# --legacy at SP degree > 1
# ---------------------------------------------------------------------------

# (n_devices, c, data, batch); prompt 12 and 5 tokens (capacity 17 -> 20)
MESH_LEGACY = {"c2r1d1": (4, 2, 1, 3), "c2r1d2": (8, 2, 2, 4),
               "c2r1d2_b3": (8, 2, 2, 3)}
MESH_PROMPT, MESH_GEN = 12, 5


def _mesh_legacy_tokens(batch, vocab):
    return np.random.default_rng(6).integers(0, vocab, (batch, MESH_PROMPT))


def jax_mesh_references():
    """The JAX islands' tokens of every ``MESH_LEGACY`` case (run in the
    child process)."""
    cfg = jax_registry.get_smoke(ARCH)
    params = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    out = {}
    for key, (n, c, data, batch) in MESH_LEGACY.items():
        plan = jax_make_serve_plan(cfg, arch=ARCH, n_devices=n, data=data,
                                   c=c)
        assert (plan.c, plan.r, plan.data) == (c, 1, data)
        out[key] = _jax_legacy_steps(
            cfg, params, plan, _mesh_legacy_tokens(batch, cfg.vocab_size),
            MESH_GEN)
    return out


_JAX_CHILD = r"""
import sys
import numpy as np
sys.path.insert(0, "tests")
from test_torch_legacy import jax_mesh_references
np.savez(sys.argv[1], **jax_mesh_references())
"""


@pytest.fixture(scope="module")
def mesh_references(tmp_path_factory):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = tmp_path_factory.mktemp("legacy") / "references.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(root, "src"))
    proc = subprocess.Popen([sys.executable, "-c", _JAX_CHILD, str(path)],
                            cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    state = {}

    def load():
        if "want" not in state:
            _, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stderr[-4000:]
            state["want"] = dict(np.load(path))
        return state["want"]

    try:
        yield load
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.mark.parametrize("case", sorted(MESH_LEGACY))
def test_legacy_on_the_mesh_matches_jax_steps(mesh_references, case):
    n, c, data, batch = MESH_LEGACY[case]
    cfg_j = jax_registry.get_smoke(ARCH)
    params = jax_build_model(cfg_j).init(jax.random.PRNGKey(0))
    model = from_jax_params(jax.tree.map(np.asarray, params),
                            registry.get_smoke(ARCH), "cpu")
    plan = make_serve_plan(model.cfg, arch=ARCH, n_devices=n, data=data,
                           c=c)
    assert (plan.c, plan.r, plan.data) == (c, 1, data)
    tokens = torch.from_numpy(_mesh_legacy_tokens(batch, cfg_j.vocab_size))
    # the capacity-sized caches: 17 positions padded to 20, 5 a rank
    _, caches, decode = serve.legacy_start(model, plan, tokens, MESH_GEN)
    assert len(caches) == n
    assert decode.steps.split == (data > 1 and batch % data == 0)
    assert all(cache["k"].shape[2] == 5 for cache in caches)
    got = serve.legacy_generate(model, plan, tokens, MESH_GEN)
    assert got.shape == (batch, MESH_GEN)
    np.testing.assert_array_equal(got.numpy(), mesh_references()[case])


def test_launch_serve_legacy_on_eight_ranks(capsys):
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--legacy", "--devices", "8", "--data", "2", "--c",
                      "2", "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert tuple(out.shape) == (2, 3)
    assert "P_sp=4" in capsys.readouterr().out
