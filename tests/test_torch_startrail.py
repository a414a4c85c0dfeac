"""repro_torch's StarTrail forward and backward on a ThreadMesh vs the JAX
reference.

Every rank of a ``ThreadMesh(c, r)`` (P = c*c*r threads in this process)
runs ``core.startrail.startrail_attention`` (or ``startrail_forward`` then
``startrail_backward``) on its shard; the shards are put back in sequence
order and held against ``repro.kernels.ref.mha_reference`` over the whole
sequence, and the gradients against ``jax.grad`` of its loss
``sum(o * do)``, as ``repro/testing/dist_checks.py:check_attention`` does.
Inputs are made with numpy from a seed and handed to both packages.
Tolerance 2e-4, that dist check's own. Beside the causal windowed
layouts at (c, r) = (1, 4), (2, 1), (2, 2), the JAX checks' other layouts
(``JAX_LAYOUTS``): the non-causal ``ring_full_contig`` and ``st2_full``,
``st2_mha``, ``st2_mqa`` and the P = 16 ``st4_p16``, ``st2_p16_r4`` and
``st2_p16_window``. ``combine_decode_partials`` is held
against the JAX ``combine_pair`` folded over the shards.

The P > 1 backward is called explicitly per rank: autograd runs the
backward of CUDA tensors on one worker thread per device, which would
serialise the ranks' collectives on a card; at P = 1 the autograd
``StarTrailAttention`` equals the explicit functions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import combine as jax_combine
from repro.kernels import ref as jax_ref
from repro_torch.core import startrail as st
from repro_torch.core.combine import NEG_INF
from repro_torch.dist.comm import SingleComm, ThreadMesh
from repro_torch.kernels import flash_attention

TOL = 2e-4
N, B, HQ, HKV, D, WINDOW = 64, 2, 4, 2, 16, 24


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, N, HQ, D)).astype(np.float32)
    k = rng.normal(size=(B, N, HKV, D)).astype(np.float32)
    v = rng.normal(size=(B, N, HKV, D)).astype(np.float32)
    return q, k, v


def _jax_grads(q, k, v, do):
    """o and jax.grad of sum(o * do) of the JAX full-attention reference."""
    def loss(q, k, v):
        o = jax_ref.mha_reference(q, k, v, causal=True, window=WINDOW)
        return (o * do).sum()

    args = tuple(jnp.asarray(x) for x in (q, k, v))
    o = jax_ref.mha_reference(*args, causal=True, window=WINDOW)
    return np.asarray(o), [np.asarray(g) for g in
                           jax.grad(loss, argnums=(0, 1, 2))(*args)]


def _ring_fwd_bwd(c, r, scheme, block_skip, q, k, v, do):
    """Every rank's explicit forward + backward, put back in sequence order:
    (o, [dq, dk, dv]) as numpy."""
    mesh = ThreadMesh(c, r)
    p = mesh.size
    cfg = st.StarTrailConfig(seq_len=N, seq_scheme=scheme, causal=True,
                             window=WINDOW, block_impl="cuda",
                             block_skip=block_skip)

    def rank_fn(comm):
        g, j, t = (comm.axis_index(a) for a in cfg.axes)
        pos = st.shard_positions((g * r + j) * c + t, N, p, scheme).numpy()
        shard = [torch.from_numpy(np.ascontiguousarray(x[:, pos]))
                 for x in (q, k, v, do)]
        o, res = st.startrail_forward(*shard[:3], cfg, comm)
        return pos, o, st.startrail_backward(res, o, shard[3], cfg, comm)

    out = np.zeros_like(q)
    grads = [np.zeros_like(x) for x in (q, k, v)]
    for pos, o, gs in mesh.run(rank_fn, timeout=120):
        out[:, pos] = o.numpy()
        for full, gr in zip(grads, gs):
            full[:, pos] = gr.numpy()
    return out, grads


@pytest.mark.parametrize("impl", ["ref", "cuda"])
@pytest.mark.parametrize("scheme", ["contiguous", "zigzag"])
@pytest.mark.parametrize("c,r", [(1, 4), (2, 1), (2, 2)])
def test_startrail_thread_mesh_matches_mha_reference(c, r, scheme, impl):
    q, k, v = _inputs()
    mesh = ThreadMesh(c, r)
    p = mesh.size
    cfg = st.StarTrailConfig(seq_len=N, seq_scheme=scheme, causal=True,
                             window=WINDOW, block_impl=impl,
                             block_skip=scheme == "contiguous")

    def rank_fn(comm):
        g, j, t = (comm.axis_index(a) for a in cfg.axes)
        rank = (g * r + j) * c + t
        pos = st.shard_positions(rank, N, p, scheme).numpy()
        o = st.startrail_attention(
            torch.from_numpy(q[:, pos]), torch.from_numpy(k[:, pos]),
            torch.from_numpy(v[:, pos]), cfg, comm)
        return pos, o

    flash_attention.reset_launches()
    out = np.zeros_like(q)
    for pos, o in mesh.run(rank_fn, timeout=120):
        out[:, pos] = o.numpy()
    # CPU tensors take the plain versions: no kernel launch is counted
    assert flash_attention.LAUNCHES == {"B1": 0, "B2": 0, "B3": 0}
    want = jax_ref.mha_reference(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True, window=WINDOW)
    np.testing.assert_allclose(out, np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("scheme", ["contiguous", "zigzag"])
@pytest.mark.parametrize("c,r", [(1, 4), (2, 1), (2, 2)])
def test_startrail_backward_matches_jax_grad(c, r, scheme):
    q, k, v = _inputs()
    do = np.random.default_rng(1).normal(size=q.shape).astype(np.float32)
    o_want, g_want = _jax_grads(q, k, v, do)
    flash_attention.reset_launches()
    out, grads = _ring_fwd_bwd(c, r, scheme, False, q, k, v, do)
    assert flash_attention.LAUNCHES == {"B1": 0, "B2": 0, "B3": 0}
    np.testing.assert_allclose(out, o_want, atol=TOL, rtol=TOL)
    for name, got, want in zip(("dq", "dk", "dv"), grads, g_want):
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL,
                                   err_msg=name)


# the layouts of the JAX ``check_attention`` dist checks the tests above
# do not cover (``repro/testing/dist_checks.py:195-235``), at their
# shapes: seq 64, batch 2, head size 8, 4q/2kv unless named
JAX_LAYOUTS = {
    # name: (c, r, causal, scheme, window, block_skip, hq, hkv)
    "ring_full_contig": (1, 8, False, "contiguous", None, False, 4, 2),
    "st2_full": (2, 2, False, "contiguous", None, False, 4, 2),
    "st2_mha": (2, 2, True, "zigzag", None, False, 4, 4),
    "st2_mqa": (2, 2, True, "zigzag", None, False, 4, 1),
    "st4_p16": (4, 1, True, "zigzag", None, False, 4, 2),
    "st2_p16_r4": (2, 4, True, "zigzag", None, False, 4, 2),
    "st2_p16_window": (2, 4, True, "contiguous", 24, True, 4, 2),
}


@pytest.mark.parametrize("name", list(JAX_LAYOUTS))
def test_startrail_at_the_jax_checks_layouts(name):
    """Forward and backward of every rank (explicit per rank, as above)
    against ``mha_reference`` and ``jax.grad`` of ``sum(o * do)`` at each
    layout of ``JAX_LAYOUTS``, the non-causal ones (the encoder's full
    mask: every ring step runs) among them; ``TOL``."""
    c, r, causal, scheme, window, skip, hq, hkv = JAX_LAYOUTS[name]
    n, d = 64, 8
    rng = np.random.default_rng(7)
    q, k, v, do = (rng.normal(size=(B, n, h, d)).astype(np.float32)
                   for h in (hq, hkv, hkv, hq))
    mesh = ThreadMesh(c, r)
    p = mesh.size
    cfg = st.StarTrailConfig(seq_len=n, seq_scheme=scheme, causal=causal,
                             window=window, block_impl="cuda",
                             block_skip=skip)

    def rank_fn(comm):
        g, j, t = (comm.axis_index(a) for a in cfg.axes)
        pos = st.shard_positions((g * r + j) * c + t, n, p, scheme).numpy()
        shard = [torch.from_numpy(np.ascontiguousarray(x[:, pos]))
                 for x in (q, k, v, do)]
        o, res = st.startrail_forward(*shard[:3], cfg, comm)
        return pos, o, st.startrail_backward(res, o, shard[3], cfg, comm)

    out = np.zeros_like(q)
    grads = [np.zeros_like(x) for x in (q, k, v)]
    for pos, o, gs in mesh.run(rank_fn, timeout=120):
        out[:, pos] = o.numpy()
        for full, gr in zip(grads, gs):
            full[:, pos] = gr.numpy()

    def loss(q, k, v):
        o = jax_ref.mha_reference(q, k, v, causal=causal, window=window)
        return (o * do).sum()

    args = tuple(jnp.asarray(x) for x in (q, k, v))
    want = jax_ref.mha_reference(*args, causal=causal, window=window)
    np.testing.assert_allclose(out, np.asarray(want), atol=TOL, rtol=TOL)
    for label, got, g in zip(("dq", "dk", "dv"), grads,
                             jax.grad(loss, argnums=(0, 1, 2))(*args)):
        np.testing.assert_allclose(got, np.asarray(g), atol=TOL, rtol=TOL,
                                   err_msg=label)


def test_block_skip_gives_the_same_gradients():
    """``block_skip`` drops fully masked ring steps (the contiguous layout
    with a window has some) without changing a value: the JAX
    ``bwd_skip_equiv`` dist check."""
    q, k, v = _inputs(2)
    do = np.random.default_rng(3).normal(size=q.shape).astype(np.float32)
    cfg = st.StarTrailConfig(seq_len=N, seq_scheme="contiguous",
                             window=WINDOW)
    pos = [st.shard_positions(i, N, 4, "contiguous") for i in range(4)]
    assert st.fully_masked(cfg, pos[0], pos[3])        # causal: all future
    assert st.fully_masked(cfg, pos[3], pos[0])        # out of the window
    off = _ring_fwd_bwd(1, 4, "contiguous", False, q, k, v, do)
    on = _ring_fwd_bwd(1, 4, "contiguous", True, q, k, v, do)
    np.testing.assert_array_equal(on[0], off[0])
    for a, b in zip(on[1], off[1]):
        np.testing.assert_array_equal(a, b)


def test_autograd_at_p1_equals_explicit_functions():
    q, k, v = (torch.from_numpy(x) for x in _inputs(4))
    do = torch.from_numpy(np.random.default_rng(5).normal(
        size=q.shape).astype(np.float32))
    cfg = st.StarTrailConfig(seq_len=N, seq_scheme="zigzag", causal=True,
                             window=WINDOW, block_impl="cuda")
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = st.startrail_attention(*leaves, cfg, SingleComm())
    got = torch.autograd.grad(o, leaves, do)
    o2, res = st.startrail_forward(q, k, v, cfg, SingleComm())
    want = st.startrail_backward(res, o2, do, cfg, SingleComm())
    assert torch.equal(o.detach(), o2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # no input needs a gradient: the forward keeps no residual
    with torch.no_grad():
        o3 = st.startrail_attention(q, k, v, cfg, SingleComm())
    assert o3.grad_fn is None and torch.equal(o3, o2)


def test_thread_mesh_rank_fault_fails_fast():
    mesh = ThreadMesh(1, 4)

    def rank_fn(comm):
        if comm.axis_index("sp_ring") == 2:
            raise ValueError("rank 2 fault")
        return comm.psum(torch.ones(1), ("sp_ring",))

    with pytest.raises(ValueError, match="rank 2 fault"):
        mesh.run(rank_fn, timeout=30)


def test_combine_decode_partials_dead_shards():
    rng = np.random.default_rng(3)
    P, Bd, H = 4, 3, 4
    o = rng.normal(size=(P, Bd, 1, H, D)).astype(np.float32)
    lse = rng.normal(size=(P, Bd, H, 1)).astype(np.float32)
    # row 0: shards 1 and 3 saw no key; row 2: no shard saw any key
    for s, b in ((1, 0), (3, 0), (0, 2), (1, 2), (2, 2), (3, 2)):
        lse[s, b] = NEG_INF
        o[s, b] = 0.0

    def rank_fn(comm):
        rank = comm.axis_index("sp_ring")
        return st.combine_partials_with_lse(
            torch.from_numpy(o[rank]), torch.from_numpy(lse[rank]), comm,
            ("sp_grp", "sp_ring", "sp_team"))

    res = ThreadMesh(1, P).run(rank_fn, timeout=30)
    o_j, lse_j = jnp.asarray(o[0]), jnp.asarray(lse[0])
    for s in range(1, P):
        o_j, lse_j = jax_combine.combine_pair(o_j, lse_j, jnp.asarray(o[s]),
                                              jnp.asarray(lse[s]))
    for o_t, lse_t in res:               # every rank holds the full merge
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=TOL,
                                   rtol=TOL)
        live = np.asarray(lse_j) > NEG_INF / 2
        np.testing.assert_allclose(lse_t.numpy()[live],
                                   np.asarray(lse_j)[live], atol=TOL,
                                   rtol=TOL)
        assert (lse_t.numpy()[~live] == np.float32(NEG_INF)).all()
    assert (res[0][0].numpy()[2] == 0.0).all()
    assert jax.devices()[0].platform == "cpu"
