"""How far f32 determines the smoke seamless-m4t gradients, in both
packages (the numbers of ``test_torch_encdec.py``'s "Precision" note).

Run from the repository root (a few minutes on a CPU):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_encdec_precision.py

For P = 1 and the islands (c, r, data) = (2, 1, 1), (1, 4, 1), (2, 1, 2)
in the zigzag layout, and in the contiguous layout on the batch's columns
taken in zigzag position order, it computes the loss and every gradient
leaf in f32 and exactly (float64 throughout: the JAX side in a child
process with 8 host devices under x64 with ``jnp.float32`` made float64,
the port under ``test_torch_encdec._exact_torch``). P = 1 runs on the
permuted sequence, the sequence the zigzag islands compute. It prints,
per run, the largest leaf error (``_leaf_errs``'s metric) of each package
in f32 against JAX's exact P = 1, the two packages' f32 runs against each
other, and their exact runs against each other.
"""

import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

LAYOUTS = [(2, 1, 1), (1, 4, 1), (2, 1, 2)]


def _order():
    """The zigzag order of the SEQ columns at SP degree 4."""
    from test_torch_encdec import SEQ
    ch = SEQ // 8
    return np.concatenate([np.r_[p * ch:(p + 1) * ch,
                                 (7 - p) * ch:(8 - p) * ch]
                           for p in range(4)])


def _runs(batch):
    """(name, layout or None, scheme, batch) of every run."""
    permuted = {k: v[:, np.argsort(_order())] for k, v in batch.items()}
    out = [("p1", None, None, permuted)]
    for lay in LAYOUTS:
        out.append((f"{lay} zigzag", lay, "zigzag", batch))
        out.append((f"{lay} contiguous", lay, "contiguous", permuted))
    return out


def jax_side(path):
    """Every run in f32 then exactly; {(name, 'f32'|'exact'): (loss,
    {path: grad})} pickled to ``path``."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import RunConfig, ShapeConfig
    from repro.dist import meshes
    from repro.train import step as jts
    from test_torch_encdec import BATCH, SEQ, _ctx

    ctx = _ctx()
    model, tree = ctx["model_j"], ctx["tree"]
    out = {}
    for prec in ("f32", "exact"):
        if prec == "exact":
            jax.config.update("jax_enable_x64", True)
            jnp.float32 = jnp.float64
        dt = np.float64 if prec == "exact" else np.float32
        params = jax.tree.map(lambda a: jnp.asarray(a, dt), tree)
        for name, lay, scheme, batch in _runs(ctx["batch"]):
            batch = dict(batch, frontend_emb=batch["frontend_emb"].astype(dt))
            shape = ShapeConfig("t", SEQ, BATCH, "train")
            if lay is None:
                rt = jts.make_runtime(model, RunConfig(c=1), shape,
                                      mode="local")
                loss, grads = jax.jit(jax.value_and_grad(
                    lambda p, b: model.loss(rt, p, b, remat="none")))(
                        params, batch)
            else:
                c, r, data = lay
                fn, _ = jts.build_value_and_grad_fn(
                    model, meshes.local_mesh_for_tests(c=c, r=r, data=data),
                    RunConfig(c=c, seq_scheme=scheme), shape)
                loss, grads = jax.jit(fn)(params, batch)
            out[(name, prec)] = (float(loss), {
                jax.tree_util.keystr(p): np.asarray(g, np.float64)
                for p, g in jax.tree_util.tree_leaves_with_path(grads)})
    with open(path, "wb") as f:
        pickle.dump(out, f)


def port_side():
    import jax
    import torch

    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.dist.comm import ThreadMesh
    from repro_torch.models.factory import from_jax_params, to_jax_layout
    from repro_torch.train import step as train_step
    from test_torch_encdec import BATCH, SEQ, _ctx, _exact_torch
    from test_torch_train_sp import mesh_whole_grads

    ctx = _ctx()
    out = {}

    def run(dtype):
        model = from_jax_params(ctx["tree"], ctx["cfg"], "cpu").to(dtype)
        names = [n for n, _ in model.named_parameters()]
        shape = ShapeConfig("t", SEQ, BATCH, "train")
        res = {}
        for name, lay, scheme, batch in _runs(ctx["batch"]):
            b = {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in batch.items()}
            b["frontend_emb"] = b["frontend_emb"].to(dtype)
            if lay is None:
                vg, _ = train_step.build_value_and_grad_fn(
                    model, RunConfig(c=1, remat="none"), shape)
                loss, grads = vg(b)
            else:
                c, r, data = lay
                losses, grads = mesh_whole_grads(
                    model, ThreadMesh(c, r, data),
                    RunConfig(c=c, seq_scheme=scheme), shape, b)
                loss = losses[0]
            tree = to_jax_layout(dict(zip(names, grads)), model.cfg)
            res[name] = (float(loss), {
                jax.tree_util.keystr(p): np.asarray(g, np.float64)
                for p, g in jax.tree_util.tree_leaves_with_path(tree)})
        return res

    for name, v in run(torch.float32).items():
        out[(name, "f32")] = v
    with _exact_torch():
        for name, v in run(torch.float64).items():
            out[(name, "exact")] = v
    return out


def _err(got, want):
    return max(float(np.max(np.abs(got[k] - want[k]))
                     / max(1.0, float(np.abs(want[k]).max())))
               for k in want)


def main():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(tempfile.mkdtemp(), "jax.pkl")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(root, "src"))
    child = subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, 'tests'); "
         "import torch_encdec_precision as m; m.jax_side(sys.argv[1])",
         path], cwd=root, env=env)
    port = port_side()
    assert child.wait() == 0
    with open(path, "rb") as f:
        jx = pickle.load(f)
    exact = jx[("p1", "exact")][1]
    print("largest leaf error; 'vs P = 1': against JAX's exact P = 1")
    print(f"{'run':<24}{'JAX f32':>10}{'port f32':>10}{'JAX exact':>11}"
          f"{'port exact':>11}   {'f32: port vs JAX':>17}"
          f"{'exact: port vs JAX':>20}")
    print(f"{'':<24}{'vs P = 1':>10}{'vs P = 1':>10}{'vs P = 1':>11}"
          f"{'vs P = 1':>11}")
    from test_torch_encdec import _ctx
    for name, *_ in _runs(_ctx()["batch"]):
        j32, p32 = jx[(name, "f32")][1], port[(name, "f32")][1]
        j64, p64 = jx[(name, "exact")][1], port[(name, "exact")][1]
        print(f"{name:<24}{_err(j32, exact):10.3g}{_err(p32, exact):10.3g}"
              f"{_err(j64, exact):11.3g}{_err(p64, exact):11.3g}   "
              f"{_err(p32, j32):17.3g}{_err(p64, j64):20.3g}")


if __name__ == "__main__":
    main()
