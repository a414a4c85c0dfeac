"""repro_torch — the PyTorch / CUDA (Hopper) port of ``repro``.

A second package beside the JAX reference ``repro``: the same module names,
PyTorch idiom inside. It imports ``torch`` and ``numpy`` and nothing of
``jax`` or ``repro``. Entry points run on the CUDA card unless the caller
asks for the CPU; on CPU tensors every kernel wrapper runs its plain
PyTorch version, on CUDA tensors it launches the hand-written kernel (built
from ``csrc/`` by ``kernels._build``) or raises.

Ported so far (the serving slice): configs, core (combine, topology,
StarTrail forward), kernels (B1/B2 flash forward with fused ring merge, B4
paged decode), dist.comm, models, serve.step, engine, plan, launch.serve.
"""
