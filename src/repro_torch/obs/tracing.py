"""Nestable spans with a thread-safe in-memory buffer, exported as
Chrome-trace-format JSON (chrome://tracing / Perfetto "traceEvents").

Two span flavours:

  * ``span(name, ...)`` records a synchronous complete event (ph="X")
    covering a with-block: a train phase (``train/data``, ``train/step``,
    ``train/ckpt``), an engine step, a prefill chunk. Nesting comes for
    free from Chrome's stack-building on (pid, tid, ts, dur).
  * ``async_begin``/``async_end`` record async events (ph="b"/"e") keyed
    by an id, for spans that outlive any one stack frame: a request's
    lifecycle in the engine, from ``add_request`` to its last token.

The disabled tracer (default, and the module-level ``NULL_TRACER``) makes
every call a no-op returning a shared null context manager — a loop pays
one attribute check per span site, nothing else, so leaving
instrumentation in place costs ~nothing when ``--trace-out`` is absent.

``annotate=True`` additionally wraps each sync span in
``torch.profiler.record_function``, so host-side spans line up with the
device timeline when a ``torch.profiler`` trace is captured alongside.

The port's own copy of ``repro.obs.tracing``: the same events and Chrome
JSON, with ``torch.profiler`` in place of ``jax.profiler``. The JAX
module's instant events and ``extend`` (merging a worker process's events)
serve its gateway and front end (ROADMAP.md §A item 7).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional


class _NullContext:
    """Reusable no-op context manager (allocated once, never per-span)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CONTEXT = _NullContext()


class Tracer:
    def __init__(self, enabled: bool = True, annotate: bool = False):
        self.enabled = enabled
        self.annotate = annotate
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._ids = itertools.count(1)
        # epoch for ts: trace-relative µs keeps numbers small and stable
        self._t0 = time.perf_counter()

    # -- clock ------------------------------------------------------------
    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    # -- sync spans -------------------------------------------------------
    def span(self, name: str, cat: str = "repro", **args):
        """Context manager recording a complete event over the block."""
        if not self.enabled:
            return _NULL_CONTEXT
        return self._span(name, cat, args)

    @contextlib.contextmanager
    def _span(self, name: str, cat: str, args: Dict[str, Any]):
        if self.annotate:
            ann = _trace_annotation(name)
        else:
            ann = _NULL_CONTEXT
        ts = self._now_us()
        with ann:
            try:
                yield self
            finally:
                dur = self._now_us() - ts
                self._emit({"name": name, "cat": cat, "ph": "X",
                            "ts": ts, "dur": dur, "pid": os.getpid(),
                            "tid": threading.get_ident(),
                            **({"args": args} if args else {})})

    # -- async (cross-frame) spans ---------------------------------------
    def async_begin(self, name: str, cat: str = "request",
                    **args) -> Optional[str]:
        """Open an async span; returns the id to pass to ``async_end``."""
        if not self.enabled:
            return None
        sid = f"s{next(self._ids)}"
        self._emit({"name": name, "cat": cat, "ph": "b", "id": sid,
                    "ts": self._now_us(), "pid": os.getpid(),
                    "tid": threading.get_ident(),
                    **({"args": args} if args else {})})
        return sid

    def async_end(self, name: str, span_id: Optional[str],
                  cat: str = "request", **args) -> None:
        if not self.enabled or span_id is None:
            return
        self._emit({"name": name, "cat": cat, "ph": "e", "id": str(span_id),
                    "ts": self._now_us(), "pid": os.getpid(),
                    "tid": threading.get_ident(),
                    **({"args": args} if args else {})})

    # -- buffer -----------------------------------------------------------
    def _emit(self, event: Dict[str, Any]) -> None:
        with self._lock:
            self._events.append(event)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    # -- export -----------------------------------------------------------
    def chrome_trace(self) -> Dict[str, Any]:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def dump(self, path) -> None:
        import pathlib

        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.chrome_trace()))


def _trace_annotation(name: str):
    """A ``torch.profiler.record_function`` range named ``name``: a no-op
    unless a profiler is recording."""
    import torch

    return torch.profiler.record_function(name)


#: Shared disabled tracer — the default for every producer, so span sites
#: cost one truthiness check when tracing is off.
NULL_TRACER = Tracer(enabled=False)
