"""Process-local metrics registry: labelled counters, rendered as
Prometheus text or JSON.

The port's own copy of the counter half of ``repro.obs.registry`` (that
module is jax-free, but the port imports nothing of ``repro``); its text
and JSON are the same for the same sequence of counter operations. The
trainer's comm-volume accounting (``obs.commlog.CommLog``) writes through
it and ``launch.train --metrics-dump`` dumps it. The JAX module's gauges,
fixed-bucket histograms, attribution scopes, global registry and
cross-process merge serve the engine's metrics and come with
``EngineMetrics`` (ROADMAP.md §A item 4).

A series is (metric name, sorted label items); a counter ``inc`` is one
dict lookup and add under a lock.
"""

from __future__ import annotations

import json
import math
import re
import threading
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# label plumbing
# ---------------------------------------------------------------------------

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


_ESCAPES = {"\\": "\\\\", "\n": "\\n", '"': '\\"'}


def _escape(v: str) -> str:
    return "".join(_ESCAPES.get(ch, ch) for ch in v)


def _fmt_labels(key: LabelKey) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in key) + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

class Counter:
    """One named family of labelled, monotonic series."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        if not re.fullmatch(r"[a-zA-Z_:][a-zA-Z0-9_:]*", name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: Dict[LabelKey, float] = {}

    def value(self, **labels) -> float:
        """The exact series' value (0.0 for a never-touched series)."""
        return self._series.get(_label_key(labels), 0.0)

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def render(self) -> List[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {_escape(self.help)}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        for key in sorted(self._series):
            lines.append(f"{self.name}{_fmt_labels(key)} "
                         f"{_fmt_value(self._series[key])}")
        return lines

    def to_json(self) -> Dict:
        return {
            "kind": self.kind,
            "help": self.help,
            "series": [{"labels": dict(k), "value": v}
                       for k, v in sorted(self._series.items())],
        }


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

class Registry:
    """A named collection of counters; get-or-create."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Counter] = {}

    def counter(self, name: str, help: str = "") -> Counter:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Counter(name, help)
            return m

    def get(self, name: str) -> Optional[Counter]:
        return self._metrics.get(name)

    def value(self, name: str, **labels) -> float:
        m = self._metrics.get(name)
        return m.value(**labels) if m else 0.0

    # -- export -----------------------------------------------------------
    def render_prometheus(self) -> str:
        lines: List[str] = []
        for name in sorted(self._metrics):
            lines.extend(self._metrics[name].render())
        return "\n".join(lines) + ("\n" if lines else "")

    def to_json(self) -> Dict:
        return {name: m.to_json()
                for name, m in sorted(self._metrics.items())}

    def dump(self, path, fmt: str = "prometheus") -> None:
        import pathlib

        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        if fmt == "prometheus":
            p.write_text(self.render_prometheus())
        elif fmt == "json":
            p.write_text(json.dumps(self.to_json(), indent=2, sort_keys=True))
        else:
            raise ValueError(f"fmt must be 'prometheus' or 'json', got {fmt!r}")


# ---------------------------------------------------------------------------
# Prometheus text parsing (reads the exported metric, not in-process state)
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)\s*$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(v: str) -> str:
    return v.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")


def parse_prometheus(text: str) -> Dict[Tuple[str, LabelKey], float]:
    """Prometheus text -> {(sample name, label key) -> value}."""
    out: Dict[Tuple[str, LabelKey], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"unparseable sample line: {line!r}")
        labels: Dict[str, str] = {}
        if m.group("labels"):
            for lm in _LABEL_RE.finditer(m.group("labels")):
                labels[lm.group(1)] = _unescape(lm.group(2))
        raw = m.group("value")
        value = {"+Inf": math.inf, "-Inf": -math.inf,
                 "NaN": math.nan}.get(raw)
        out[(m.group("name"), _label_key(labels))] = \
            float(raw) if value is None else value
    return out
