"""repro_torch stands alone: no JAX, nothing of ``repro``, no CPU fallback.

* In a subprocess where ``import jax`` fails, every module of
  ``repro_torch`` imports.
* No file under ``src/repro_torch/`` (nor ``chip_smoke.py``) has an
  ``import jax`` / ``from jax`` / ``import repro`` / ``from repro.`` line.
* ``build_engine()``, ``build_gateway()`` and a front-end worker spec
  with no device, and ``python -m repro_torch.launch.train`` without
  ``--device``, in a process without CUDA, raise instead of running on
  the CPU.
"""

import os
import pathlib
import re
import subprocess
import sys

import jax  # noqa: F401  (both frameworks share the test process)
import torch  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
BAD = re.compile(r"^\s*(import jax\b|from jax\b|import repro(\s|\.|$)|"
                 r"from repro(\s|\.))")


def _run(code: str, **env):
    full = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **env)
    return subprocess.run([sys.executable, "-c", code], env=full,
                          capture_output=True, text=True, timeout=240)


def test_every_module_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "for n in ('repro_torch.engine.engine', 'repro_torch.train.trainer',\n"
        "          'repro_torch.train.step', 'repro_torch.optim.adamw',\n"
        "          'repro_torch.data.pipeline', 'repro_torch.launch.train',\n"
        "          'repro_torch.dist.elastic', 'repro_torch.gateway',\n"
        "          'repro_torch.gateway.prefix_cache',\n"
        "          'repro_torch.serve.kv_cache',\n"
        "          'repro_torch.kernels.ragged_prefill',\n"
        "          'repro_torch.kernels.paged_prefill',\n"
        "          'repro_torch.kernels.ragged_bwd',\n"
        "          'repro_torch.dist.checkpoint', 'repro_torch.optim.grad',\n"
        "          'repro_torch.core.ulysses', 'repro_torch.kernels.ops',\n"
        "          'repro_torch.plan.cost', 'repro_torch.plan.autotune',\n"
        "          'repro_torch.core.scheduler', 'repro_torch.roofline.hw',\n"
        "          'repro_torch.obs', 'repro_torch.obs.registry',\n"
        "          'repro_torch.obs.tracing', 'repro_torch.obs.commlog',\n"
        "          'repro_torch.configs.minitron_8b',\n"
        "          'repro_torch.configs.deepseek_7b',\n"
        "          'repro_torch.configs.stablelm_3b',\n"
        "          'repro_torch.configs.paper_models',\n"
        "          'repro_torch.configs.phi3_5_moe_42b_a6_6b',\n"
        "          'repro_torch.configs.llama4_maverick_400b_a17b',\n"
        "          'repro_torch.models.moe',\n"
        "          'repro_torch.configs.xlstm_1_3b', 'repro_torch.models.ssm',\n"
        "          'repro_torch.gateway.router', 'repro_torch.gateway.gateway',\n"
        "          'repro_torch.frontend', 'repro_torch.frontend.protocol',\n"
        "          'repro_torch.frontend.slo', 'repro_torch.frontend.worker',\n"
        "          'repro_torch.frontend.orchestrator',\n"
        "          'repro_torch.frontend.server',\n"
        "          'repro_torch.frontend.client',\n"
        "          'repro_torch.launch.dryrun', 'repro_torch.roofline.model',\n"
        "          'repro_torch.kernels.meta'):\n"
        "    assert n in names, (n, names)\n"
        "print(len(names))\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 86


def test_no_jax_or_repro_import_lines():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [f"{f.relative_to(ROOT)}:{i}: {line.strip()}"
                 for f in files
                 for i, line in enumerate(f.read_text().splitlines(), 1)
                 if BAD.match(line)]
    assert not offenders, offenders


def test_build_engine_without_cuda_raises():
    code = (
        "from repro_torch.engine import build_engine\n"
        "try:\n"
        "    build_engine('h2o-danube-1.8b', smoke=True)\n"
        "except RuntimeError as e:\n"
        "    assert 'CUDA' in str(e), e\n"
        "    print('raised')\n")
    res = _run(code, CUDA_VISIBLE_DEVICES="")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "raised"


def test_gateway_and_worker_without_cuda_raise():
    code = (
        "from repro_torch.configs import registry\n"
        "from repro_torch.engine import EngineConfig\n"
        "from repro_torch.frontend.protocol import make_worker_spec\n"
        "from repro_torch.frontend.worker import LocalReplica\n"
        "from repro_torch.gateway import build_gateway\n"
        "from repro_torch.plan import make_serve_plan\n"
        "plan = make_serve_plan(registry.get_smoke('h2o-danube-1.8b'),\n"
        "                       arch='h2o-danube-1.8b')\n"
        "for build in (lambda: build_gateway('h2o-danube-1.8b',\n"
        "                                    replicas=2),\n"
        "              lambda: LocalReplica(0, make_worker_spec(\n"
        "                  plan=plan, eng=EngineConfig()))):\n"
        "    try:\n"
        "        build()\n"
        "    except RuntimeError as e:\n"
        "        assert 'CUDA' in str(e), e\n"
        "        print('raised')\n")
    res = _run(code, CUDA_VISIBLE_DEVICES="")
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["raised", "raised"]


def test_launch_train_without_device_raises_without_cuda():
    full = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "h2o-danube-1.8b", "--smoke", "--steps", "1"], env=full,
        capture_output=True, text=True, timeout=240)
    assert res.returncode != 0
    assert "RuntimeError" in res.stderr and "CUDA" in res.stderr, res.stderr
    assert "[trainer]" not in res.stdout
