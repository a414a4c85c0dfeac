"""repro_torch.obs: the metrics registry, span tracing, and per-collective
communication accounting held against the paper's eqs. 2-4
(``obs.commlog``). The port's counterpart of ``repro.obs``."""

from repro_torch.obs.registry import (  # noqa: F401
    INTERTOKEN_BUCKETS, TTFT_BUCKETS, Counter, Gauge, Histogram, Registry,
    parse_prometheus,
)
from repro_torch.obs.tracing import NULL_TRACER, Tracer  # noqa: F401

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "Tracer",
           "NULL_TRACER", "TTFT_BUCKETS", "INTERTOKEN_BUCKETS",
           "parse_prometheus"]
