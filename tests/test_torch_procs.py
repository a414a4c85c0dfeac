"""repro_torch's ranks as processes: ``dist.comm.ProcessComm`` over gloo on
the CPU, launched by ``dist.procs.ProcessMesh``, against the
``ThreadMesh`` and the JAX package.

Three spawns of rank processes (``tests/torch_procs_ranks.py``, which
imports no JAX) serve every check, on the smoke h2o-danube-1.8b (f32, 2
layers) with the JAX weights and the batch of ``test_torch_train_sp.py``;
meshes are named (data, C, R):

* at (1, 2, 1), 4 processes: each collective (forward, and the backward,
  the transposed collective) equal to the ``ThreadMesh``'s bit for bit,
  and its ledger; ranks of a group in different collectives, or with
  different shapes, all raise and then meet again; no child imports JAX
  or ``repro``; value and gradients (and the JAX island within 2e-3);
  three AdamW steps under ``none`` and ``int8``; one train step's ledger;
  a trainer checkpoint, and the restore of the ``ThreadMesh``'s;
* at (1, 1, 2), 2 processes: the restore of the 4 processes' checkpoint,
  and a checkpoint of their own;
* at (2, 1, 2), 4 processes: value and gradients, and the restore of the
  2 processes' checkpoint.

Value: loss within 1e-6, gradient leaves within 1e-5 of the ``ThreadMesh``
(f32), replicas of a shard the same bits; checkpoints cross between
processes and threads, and between 4 and 2 processes, bit for bit. Also:
``launch.train --backend gloo`` prints ``--backend threads``' losses, a
failing rank stops the others, ``nccl`` with more ranks than cards raises,
``plan_mesh`` equals the JAX one, and concurrent processes building the
kernel library see one build and a whole file.
"""

import dataclasses
import hashlib
import multiprocessing
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import torch_procs_ranks as ranks
from repro.dist import elastic as jax_elastic
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.dist import elastic
from repro_torch.dist.comm import ThreadMesh
from repro_torch.dist.procs import ProcessMesh
from repro_torch.launch import train as launch_train
from repro_torch.models.factory import from_jax_params, shard_blocks
from repro_torch.optim import adamw
from repro_torch.plan import make_plan
from repro_torch.train import step as train_step
from repro_torch.train import trainer
from test_torch_train_sp import (BATCH, SEQ, TOL, _ctx, _jax_value_and_grad,
                                 _max_errs, _sharded)

ROOT = pathlib.Path(__file__).resolve().parents[1]
RUN_TIMEOUT = 240.0
# (data, C, R) -> ThreadMesh / ProcessMesh arguments (c, r, data)
MESHES = {"121": (2, 1, 1), "112": (1, 2, 1), "212": (1, 2, 2)}
SHAPE = ShapeConfig("test", SEQ, BATCH, "train")


def _plan(key):
    c, r, data = MESHES[key]
    return make_plan(_ctx()["cfg"], SHAPE, n_devices=data * c * c * r,
                     data=data, c=c, scheme="startrail" if c > 1 else "ring",
                     comm_chunks=1, remat="none")


def _batch(key):
    c, r, _ = MESHES[key]
    return _sharded(_ctx()["batch"], c * c * r)


def _whole_model():
    ctx = _ctx()
    return from_jax_params(ctx["tree"], ctx["cfg"], "cpu")


def _thread_run(key, fn, *args):
    c, r, data = MESHES[key]
    return ThreadMesh(c, r, data).run(lambda comm: fn(comm, *args),
                                      timeout=RUN_TIMEOUT)


def _proc_run(key, *calls):
    c, r, data = MESHES[key]
    return ProcessMesh(c, r, data, device="cpu", timeout=120.0).run(
        ranks.jobs, *calls, timeout=RUN_TIMEOUT)


def _restored(ckpt_dir):
    """(step, whole params, mu, nu) of a checkpoint, restored on the
    ``ThreadMesh``'s storage (whole tensors)."""
    model = _whole_model()
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    opt = adamw.init_state(params, adamw.AdamWConfig(**ranks.ADAM))
    step = trainer.restore_latest(ckpt_dir, model, names, opt)
    return step, params, opt["mu"], opt["nu"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawn's results, and the ThreadMesh-written checkpoint."""
    tmp = tmp_path_factory.mktemp("procs")
    tree = _ctx()["tree"]
    ckpt = {k: str(tmp / k) for k in ("threads", "procs4", "procs2")}
    trainer.train(_whole_model(), _plan("121"),
                  adamw.AdamWConfig(**ranks.ADAM),
                  trainer.TrainerConfig(num_steps=2, ckpt_every=2,
                                        ckpt_dir=ckpt["threads"],
                                        log_every=2), device="cpu")
    out = {"ckpt": ckpt}
    out["121"] = _proc_run(
        "121", ("imports", ()), ("collectives", ()), ("mismatch", ()),
        ("value_and_grad", (tree, _batch("121"), 2, SEQ, BATCH)),
        ("adam_steps", (tree, _batch("121"), 2, SEQ, BATCH, "none", 3)),
        ("adam_steps", (tree, _batch("121"), 2, SEQ, BATCH, "int8", 3)),
        ("save", (tree, _plan("121"), ckpt["procs4"], 2)),
        ("restore", (tree, _plan("121"), ckpt["threads"])))
    out["112"] = _proc_run(
        "112", ("restore", (tree, _plan("112"), ckpt["procs4"])),
        ("save", (tree, _plan("112"), ckpt["procs2"], 2)))
    out["212"] = _proc_run(
        "212", ("value_and_grad", (tree, _batch("212"), 1, SEQ, BATCH)),
        ("restore", (tree, _plan("212"), ckpt["procs2"])))
    return out


def _job(runs, key, index):
    """Job ``index`` of the spawn ``key``: every rank's result."""
    return [rank[index] for rank in runs[key]]


# ---- collectives ------------------------------------------------------------

@pytest.mark.parametrize("op", [op for op, _, _ in ranks.COLLECTIVES])
def test_collective_matches_thread_mesh(runs, op):
    """Each collective's output, and its backward (the transposed
    collective) where it has one, equal the ThreadMesh's bit for bit on
    every rank."""
    want = _thread_run("121", ranks.collectives)
    got = _job(runs, "121", 1)
    for rank, ((g, _), (w, _)) in enumerate(zip(got, want)):
        for a, b in zip(g[op], w[op]):
            assert (a is None) == (b is None), (op, rank)
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(a, b), (op, rank)


def test_collective_ledger_matches_thread_mesh(runs):
    want = _thread_run("121", ranks.collectives)
    got = _job(runs, "121", 1)
    assert [g[1] for g in got] == [w[1] for w in want]
    assert got[0][1]["backward"]["reduce-scatter"] > 0


def test_mismatched_collectives_raise_on_every_rank(runs):
    for errors, after in _job(runs, "121", 2):
        assert len(errors) == 2 and all(
            e is not None and "collective mismatch" in e for e in errors)
        assert "all_gather" in errors[0] and "(5,)" in errors[1]
        assert torch.equal(after, torch.full((4,), 4.0))


def test_rank_processes_import_no_jax(runs):
    assert _job(runs, "121", 0) == [[]] * 4


# ---- training --------------------------------------------------------------

def _assemble(results, shapes):
    """Whole tensors from every rank's (tensors, blocks): replicas of a
    block must hold the same bits, and the blocks cover every leaf."""
    whole = [torch.full(s, float("nan")) for s in shapes]
    seen = {}
    for tensors, blocks in results:
        for i, (t, block) in enumerate(zip(tensors, blocks)):
            key = (i, tuple((b.start, b.stop) for b in block))
            if key in seen:
                assert torch.equal(seen[key], t), key
            else:
                seen[key] = t
                whole[i][block] = t
    assert all(not torch.isnan(w).any() for w in whole)
    return whole


def _thread_vg(key):
    c = MESHES[key][0]
    model = _whole_model()

    def rank_fn(comm):
        vg_fn, rt = train_step.build_value_and_grad_fn(
            model, RunConfig(c=c, seq_scheme="zigzag", remat="none"), SHAPE,
            comm)
        comm.ledger.reset()
        loss, grads = vg_fn(train_step.shard_batch(_batch(key), rt))
        return (loss, grads, shard_blocks(model, comm, rt.rules),
                comm.ledger.snapshot())

    return model, _thread_run(key, rank_fn)


@pytest.mark.parametrize("key", ["121", "212"])
def test_value_and_grad_match_thread_mesh(runs, key):
    model, want = _thread_vg(key)
    got = _job(runs, key, 3 if key == "121" else 0)
    shapes = [p.shape for p in model.parameters()]
    g_whole = _assemble([(g, b) for _, g, b, _ in got], shapes)
    w_whole = _assemble([(g, b) for _, g, b, _ in want], shapes)
    for (lg, *_), (lw, *_) in zip(got, want):
        assert abs(float(lg) - float(lw)) <= 1e-6
    assert all(torch.equal(g[0], got[0][0]) for g in got)
    for a, b in zip(g_whole, w_whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert [g[3] for g in got] == [w[3] for w in want]


def test_value_and_grad_match_jax_island(runs):
    loss_j, grads_j = _jax_value_and_grad()
    model = _whole_model()
    got = _job(runs, "121", 3)
    whole = _assemble([(g, b) for _, g, b, _ in got],
                      [p.shape for p in model.parameters()])
    assert abs(float(got[0][0]) - float(loss_j)) < TOL
    leaves = _max_errs(model, whole, grads_j)
    worst = max(leaves, key=lambda kv: kv[1])
    assert len(leaves) == 12 and np.isfinite(worst[1]) and worst[1] < TOL, \
        worst


def _thread_steps(compression):
    model = _whole_model()
    adam = adamw.AdamWConfig(**ranks.ADAM)
    mesh = ThreadMesh(*MESHES["121"])
    step_fn, sh = train_step.build_train_step(
        model, RunConfig(c=2, seq_scheme="zigzag", remat="none",
                         grad_compression=compression), SHAPE, adam, mesh)
    opt = adamw.init_state(sh["params"], adam)
    metrics, ledgers = [], None
    for _ in range(3):
        mesh.reset_ledgers()
        opt, m = step_fn(opt, _batch("121"))
        metrics.append({k: float(v) for k, v in m.items()})
        ledgers = ledgers or [led.snapshot() for led in mesh.ledgers]
    return model, metrics, sh["params"], opt, ledgers


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_adamw_steps_match_thread_mesh(runs, compression):
    """Three steps on one batch: the losses, gradient norms, parameters
    and moments of the ranks' shards against the ThreadMesh step's."""
    model, metrics, params, opt, _ = _thread_steps(compression)
    got = _job(runs, "121", 4 if compression == "none" else 5)
    for m in [g[0] for g in got]:
        for a, b in zip(m, metrics):
            for k in ("loss", "grad_norm", "lr"):
                assert abs(a[k] - b[k]) <= 1e-6 * max(1.0, abs(b[k])), k
    shapes = [p.shape for p in params]
    for index, want in ((1, params), (2, opt["mu"]), (3, opt["nu"])):
        whole = _assemble([(g[index], g[5]) for g in got], shapes)
        for a, b in zip(whole, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-7)


def test_train_step_ledger_matches_thread_mesh(runs):
    *_, ledgers = _thread_steps("none")
    got = [g[4] for g in _job(runs, "121", 4)]
    assert got == ledgers
    assert got[0]["backward"]["all-reduce"] > 0


# ---- checkpoints -----------------------------------------------------------

# (writer, the spawn that restores it or None for the ThreadMesh, its job)
CROSSINGS = {
    "procs4_to_threads": ("procs4", None, None),
    "threads_to_procs4": ("threads", "121", 7),
    "procs4_to_procs2": ("procs4", "112", 0),
    "procs2_to_procs4": ("procs2", "212", 1),
}


@pytest.mark.parametrize("crossing", sorted(CROSSINGS))
def test_checkpoint_crosses_meshes(runs, crossing):
    writer, key, job = CROSSINGS[crossing]
    step, params, mu, nu = _restored(runs["ckpt"][writer])
    assert step == 2
    if key is None:
        # the 4 processes' trained shards are the restored leaves' blocks
        saved = _job(runs, "121", 6)
        whole = _assemble(saved, [p.shape for p in params])
        assert all(torch.equal(a, b) for a, b in zip(whole, params))
        # and the ThreadMesh trained the same plan to nearly the same
        _, t_params, _, _ = _restored(runs["ckpt"]["threads"])
        for a, b in zip(params, t_params):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6)
        return
    for r_step, r_params, r_mu, r_nu, blocks in _job(runs, key, job):
        assert r_step == 2
        for got, want in ((r_params, params), (r_mu, mu), (r_nu, nu)):
            assert all(torch.equal(g, w[b])
                       for g, w, b in zip(got, want, blocks))


# ---- the launcher ----------------------------------------------------------

def _launch(capfd, backend):
    metrics = launch_train.main([
        "--arch", "h2o-danube-1.8b", "--smoke", "--device", "cpu",
        "--backend", backend, "--devices", "4", "--steps", "2"])
    out = capfd.readouterr().out
    return metrics, [line for line in out.splitlines()
                     if line.startswith("[trainer] step")]


def test_launch_train_gloo_prints_the_threads_losses(capfd):
    got, got_lines = _launch(capfd, "gloo")
    want, want_lines = _launch(capfd, "threads")
    assert got_lines and got_lines == want_lines
    for k in ("loss", "grad_norm", "lr"):
        assert abs(got[k] - want[k]) <= 1e-6 * max(1.0, abs(want[k])), k


def test_a_failing_rank_stops_the_others():
    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="rank 1 fails on purpose") as e:
        ProcessMesh(1, 2, device="cpu").run(ranks.fail, timeout=60)
    assert time.perf_counter() - t0 < 60
    assert any("raised on rank 1" in n for n in e.value.__notes__)


def test_nccl_needs_a_card_per_rank():
    with pytest.raises(RuntimeError, match="one rank per card"):
        ProcessMesh(2, 1, backend="nccl").run(ranks.fail)
    with pytest.raises(ValueError, match="nccl runs on CUDA"):
        ProcessMesh(2, 1, backend="nccl", device="cpu")


# ---- plan_mesh and the kernel build ----------------------------------------

@pytest.mark.parametrize("world,target", [
    (512, 16), (511, 16), (12, 16), (8, 4), (6, 4), (4, 4), (16, 8),
    (2, 16), (3, 4), (0, 4)])
def test_plan_mesh_matches_jax(world, target):
    try:
        want = jax_elastic.plan_mesh(world, model_axis_target=target)
    except ValueError:
        with pytest.raises(ValueError):
            elastic.plan_mesh(world, model_axis_target=target)
        return
    got = elastic.plan_mesh(world, model_axis_target=target)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert (got.devices, got.stranded) == (want.devices, want.stranded)


def test_build_lock_gives_one_build_and_a_whole_file(tmp_path):
    """Four processes load the library at once: one builds (into a
    temporary file renamed into place, its log first), the others wait on
    the lock and read the whole file."""
    out, log = tmp_path / "lib.so", tmp_path / "lib.ptxas.txt"
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(4) as pool:
        got = pool.starmap(ranks.load_built, [(str(out), str(log))] * 4)
    whole = b"".join(bytes([i]) * 4096 for i in range(16))
    assert sorted(b for b, _, _ in got) == [False, False, False, True]
    assert {h for _, h, _ in got} == {hashlib.sha256(whole).hexdigest()}
    assert {text for _, _, text in got} == {"log of the stand-in build"}
    assert len((tmp_path / "builds").read_text().split()) == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        ".lock", "builds", "lib.ptxas.txt", "lib.so"]


def _joined(rank, world, devices):
    """``launch.train --backend gloo`` as rank ``rank`` of a ``torchrun``
    world of ``world`` (its environment; the store on a free localhost
    port): (exit code, the ``[trainer]``/``[train] done`` lines)."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
               WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "h2o-danube-1.8b", "--smoke", "--device", "cpu", "--backend",
         "gloo", "--devices", str(devices), "--steps", "2"],
        env=env, capture_output=True, text=True, timeout=RUN_TIMEOUT)
    return out.returncode, [line for line in out.stdout.splitlines()
                            if line.startswith(("[trainer] step",
                                                "[train] done"))]


def test_a_joined_rank_trains_as_threads_do(capfd):
    """Under torchrun's environment a single rank joins instead of
    spawning, and trains as ``--backend threads`` does; a rank that
    ``plan_mesh`` strands exits at once."""
    rc, lines = _joined(0, 1, 1)
    metrics = launch_train.main([
        "--arch", "h2o-danube-1.8b", "--smoke", "--device", "cpu",
        "--steps", "2"])
    want = [line for line in capfd.readouterr().out.splitlines()
            if line.startswith("[trainer] step")]
    assert rc == 0 and lines[:-1] == want and want
    assert f"'loss': {metrics['loss']}" in lines[-1]
    assert _joined(2, 3, 2) == (0, [])
