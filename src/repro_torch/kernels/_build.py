"""Build and bind the port's CUDA kernels: nvcc into one shared library with
a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds, not minutes).

``library()`` compiles every ``src/repro_torch/csrc/*.cu`` for ``sm_90a``
(one ``nvcc -c`` per source, all started together, then one link) into
``build/repro_torch/librepro_torch_<hash>.so`` under the checkout, keyed by
a hash of the sources, headers and flags, and loads it. It runs at the
first kernel launch, never at import: the CPU tests import every module and
have no ``nvcc``. ``build_info()`` reports the build seconds and the
``-Xptxas -v`` register / shared-memory / spill summary of the build.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import time
from typing import Dict, List

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every C entry: each pointer and the stream as c_void_p
SIGNATURES = {
    "repro_flash_fwd": [_VP] * 9 + [_I] * 12 + [_F, _VP],
    "repro_flash_bwd": [_VP] * 11 + [_I] * 12 + [_F, _VP],
    "repro_paged_decode": [_VP] * 7 + [_I] * 11 + [_F, _I, _VP],
}

_info: Dict[str, object] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the repro_torch CUDA kernels are built from "
            "src/repro_torch/csrc at first use and need the CUDA toolkit")
    return path


def _sources() -> List[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _ptxas_summary(log: str) -> List[str]:
    """One line per kernel: registers, static shared memory, spills."""
    out: List[str] = []
    fn, spill = None, "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spill = m.group(1), "?"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"{m.group(1)}B/{m.group(2)}B"
            continue
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and fn:
            smem = re.search(r"(\d+) bytes smem", m.group(2))
            out.append(f"{fn}: {m.group(1)} regs, "
                       f"{smem.group(1) if smem else 0}B static smem, "
                       f"spill stores/loads {spill}")
            fn = None
    return out


def _build(out: pathlib.Path) -> str:
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in _sources():
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs = []
        for src, proc in procs:
            log, _ = proc.communicate()
            logs.append(log)
            if proc.returncode != 0:
                for _, other in procs:
                    if other.poll() is None:
                        other.kill()
                        other.wait()
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        so_tmp = pathlib.Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(so_tmp), *[str(pathlib.Path(tmp) / (s.stem + ".o"))
                                  for s in _sources()]],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(so_tmp, out)       # atomic: a torn build is never loaded
    return "\n".join(logs)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has no
    library in ``build/repro_torch`` yet."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    key = source_hash()
    out = BUILD_DIR / f"librepro_torch_{key}.so"
    log_path = BUILD_DIR / f"librepro_torch_{key}.ptxas.txt"
    t0 = time.perf_counter()
    built = not out.exists()
    if built:
        log_path.write_text(_build(out))
    _info.update(
        seconds=time.perf_counter() - t0, built=built, path=str(out),
        ptxas=_ptxas_summary(log_path.read_text())
        if log_path.exists() else [])
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build_info() -> Dict[str, object]:
    """Seconds, path and ptxas summary of the library ``library()`` loaded."""
    library()
    return dict(_info)


def check(err: int, name: str) -> None:
    """Raise if a C entry returned a non-zero ``cudaGetLastError()``."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
