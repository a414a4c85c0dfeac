"""repro_torch.engine — continuous-batching serving engine with a paged KV
cache (the port of ``repro.engine``).

Public surface:
  Request                — one serving request (prompt, budget, sampling)
  Engine / EngineConfig  — add_request / step / collect / run driver
  build_engine           — resolves a one-card serve plan and builds the
                           engine, on the CUDA card unless told otherwise
  paged_cache            — page-pool layout, in-place write/insert helpers
  sampling               — vocab-parallel greedy and sampled decoding
                           (temperature, top-k, top-p)
  scheduler              — FIFO continuous-batching slot/page bookkeeping
"""

from repro_torch.engine.engine import (Engine, EngineConfig, EngineMetrics,
                                       build_engine)
from repro_torch.engine.paged_cache import PagePool
from repro_torch.engine.scheduler import (Rejection, Request, Scheduler,
                                          SlotState, bucket_pow2)

__all__ = [
    "Engine", "EngineConfig", "EngineMetrics", "build_engine", "PagePool",
    "Rejection", "Request", "Scheduler", "SlotState", "bucket_pow2",
]
