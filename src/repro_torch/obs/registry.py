"""Process-local metrics registry: labelled counters, gauges and
fixed-bucket histograms, rendered as Prometheus text or JSON.

The port's own copy of ``repro.obs.registry`` (that module is jax-free, but
the port imports nothing of ``repro``); its text and JSON are the same for
the same sequence of operations. The trainer's comm-volume accounting
(``obs.commlog.CommLog``) and the serving engine's ``EngineMetrics`` write
through it; ``launch.train`` and ``launch.serve --metrics-dump`` dump it.
The front end's orchestrator folds each worker process's scrape into one
exposition through ``merge_prometheus_text``. The JAX module's attribution
scopes and global registry serve its kernel dispatch's fallback counters,
which the port does not have.

A series is (metric name, sorted label items); a counter ``inc`` is one
dict lookup and add under a lock, a histogram ``observe`` a bisect over
the pinned bounds.
"""

from __future__ import annotations

import bisect
import json
import math
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# label plumbing
# ---------------------------------------------------------------------------

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _matches(key: LabelKey, subset: Dict[str, object]) -> bool:
    have = dict(key)
    return all(have.get(k) == str(v) for k, v in subset.items())


_ESCAPES = {"\\": "\\\\", "\n": "\\n", '"': '\\"'}


def _escape(v: str) -> str:
    return "".join(_ESCAPES.get(ch, ch) for ch in v)


def _fmt_labels(key: LabelKey, extra: Sequence[Tuple[str, str]] = ()) -> str:
    items = list(key) + list(extra)
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in items) + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


# ---------------------------------------------------------------------------
# metric kinds
# ---------------------------------------------------------------------------

class Metric:
    """Base: one named family of labelled series."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        if not re.fullmatch(r"[a-zA-Z_:][a-zA-Z0-9_:]*", name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: Dict[LabelKey, float] = {}

    # -- reads ------------------------------------------------------------
    def value(self, **labels) -> float:
        """The exact series' value (0.0 for a never-touched series)."""
        return self._series.get(_label_key(labels), 0.0)

    # -- writes -----------------------------------------------------------
    def _add(self, amount: float, labels: Dict[str, object]) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def _put(self, value: float, labels: Dict[str, object]) -> None:
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def reset(self, **labels) -> None:
        """Drop series matching the label subset (all, when unlabelled)."""
        with self._lock:
            for k in [k for k in self._series if _matches(k, labels)]:
                del self._series[k]

    # -- rendering --------------------------------------------------------
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


class Counter(Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        self._add(amount, labels)

    def set(self, value: float, **labels) -> None:
        """Process-local reset support (``EngineMetrics.reset``); a scraped
        counter should only ever ``inc``."""
        self._put(value, labels)


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._put(value, labels)


# Deterministic fixed buckets (seconds): TTFT spans ms to a minute, the
# inter-token gap the decode step's scale. Pinned so quantiles are
# reproducible run to run; a gap past the last bound lands in +Inf and its
# quantile clamps to that bound.
TTFT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
INTERTOKEN_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                      0.1, 0.25, 0.5, 1.0, 2.5)


class Histogram(Metric):
    """Fixed-bucket histogram; per series (bucket counts, sum, count).

    ``self._series`` (from the base class) holds the ``_sum`` line,
    ``self._counts[key]`` the per-bucket counts (the last one +Inf) and
    ``self._n[key]`` the observation count.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = TTFT_BUCKETS):
        super().__init__(name, help)
        bounds = tuple(float(b) for b in buckets)
        if list(bounds) != sorted(set(bounds)) or not bounds:
            raise ValueError(f"histogram {name}: buckets must be strictly "
                             f"increasing and non-empty, got {buckets}")
        if bounds[-1] == math.inf:
            bounds = bounds[:-1]
        self.buckets = bounds
        self._counts: Dict[LabelKey, List[int]] = {}
        self._n: Dict[LabelKey, int] = {}

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        i = bisect.bisect_left(self.buckets, float(value))
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * (len(self.buckets) + 1)
                self._n[key] = 0
            counts[i] += 1
            self._n[key] += 1
            self._series[key] = self._series.get(key, 0.0) + float(value)

    def count(self, **labels) -> int:
        return sum(n for k, n in self._n.items() if _matches(k, labels))

    def bucket_counts(self, **labels) -> List[int]:
        """Per-bucket (non-cumulative) counts summed over matching series;
        the final entry is the +Inf overflow bucket."""
        out = [0] * (len(self.buckets) + 1)
        for k, counts in self._counts.items():
            if _matches(k, labels):
                for i, c in enumerate(counts):
                    out[i] += c
        return out

    def quantile(self, q: float, **labels) -> float:
        """Quantile estimate from the fixed buckets (linear interpolation
        inside the located bucket). The +Inf bucket clamps to the largest
        finite bound: the estimate is a lower bound there."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        counts = self.bucket_counts(**labels)
        total = sum(counts)
        if total == 0:
            return 0.0
        rank = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i] if i < len(self.buckets) \
                    else self.buckets[-1]
                frac = (rank - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return self.buckets[-1]

    def reset(self, **labels) -> None:
        with self._lock:
            for k in [k for k in self._counts if _matches(k, labels)]:
                del self._counts[k]
                del self._n[k]
        super().reset(**labels)

    def render(self) -> List[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {_escape(self.help)}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        for key in sorted(self._counts):
            cum = 0
            for bound, c in zip(self.buckets, self._counts[key]):
                cum += c
                lines.append(
                    f"{self.name}_bucket"
                    f"{_fmt_labels(key, [('le', _fmt_value(bound))])} {cum}")
            cum += self._counts[key][-1]
            lines.append(f"{self.name}_bucket"
                         f"{_fmt_labels(key, [('le', '+Inf')])} {cum}")
            lines.append(f"{self.name}_sum{_fmt_labels(key)} "
                         f"{_fmt_value(self._series.get(key, 0.0))}")
            lines.append(f"{self.name}_count{_fmt_labels(key)} "
                         f"{self._n[key]}")
        return lines

    def to_json(self) -> Dict:
        d = super().to_json()
        d["buckets"] = list(self.buckets)
        d["series"] = [{"labels": dict(k),
                        "counts": list(self._counts[k]),
                        "sum": self._series.get(k, 0.0),
                        "count": self._n[k]}
                       for k in sorted(self._counts)]
        return d


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

class Registry:
    """A named collection of metrics; get-or-create with kind checking."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    def _get_or_create(self, cls, name: str, help: str, **kw) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = TTFT_BUCKETS) -> Histogram:
        h = self._get_or_create(Histogram, name, help, buckets=buckets)
        if tuple(float(b) for b in buckets) != h.buckets:
            raise ValueError(f"histogram {name!r} already registered with "
                             f"buckets {h.buckets}")
        return h

    def get(self, name: str) -> Optional[Metric]:
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


def _parse_sample(line: str) -> Tuple[str, LabelKey, float]:
    """One exposition sample line -> (sample name, label key, value)."""
    m = _SAMPLE_RE.match(line)
    if not m:
        raise ValueError(f"unparseable sample line: {line!r}")
    labels: Dict[str, str] = {}
    if m.group("labels"):
        for lm in _LABEL_RE.finditer(m.group("labels")):
            labels[lm.group(1)] = _unescape(lm.group(2))
    raw = m.group("value")
    value = {"+Inf": math.inf, "-Inf": -math.inf, "NaN": math.nan}.get(raw)
    return (m.group("name"), _label_key(labels),
            float(raw) if value is None else value)


def parse_prometheus(text: str) -> Dict[Tuple[str, LabelKey], float]:
    """Prometheus text -> {(sample name, label key) -> value}. Histogram
    series appear under their ``_bucket``/``_sum``/``_count`` sample
    names, as scraped."""
    out: Dict[Tuple[str, LabelKey], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            name, key, value = _parse_sample(line)
            out[(name, key)] = value
    return out


def parse_prometheus_families(text: str) -> Dict[str, Dict]:
    """``# TYPE``-aware Prometheus text parse: {family name -> {"kind",
    "help", "samples"}}, ``samples`` mapping (sample name, label key) ->
    value, histogram sample names keeping their ``_bucket``/``_sum``/
    ``_count`` suffixes. A family without a ``# TYPE`` line parses as
    ``untyped`` under its sample name."""
    kinds: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    out: Dict[str, Dict] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            name, _, kind = line[len("# TYPE "):].partition(" ")
            kinds[name] = kind.strip()
            continue
        if line.startswith("# HELP "):
            name, _, h = line[len("# HELP "):].partition(" ")
            helps[name] = _unescape(h)
            continue
        if line.startswith("#"):
            continue
        sample, key, value = _parse_sample(line)
        family = sample
        for suffix in ("_bucket", "_sum", "_count"):
            base = sample[:-len(suffix)] if sample.endswith(suffix) else None
            if base and kinds.get(base) == "histogram":
                family = base
                break
        fam = out.setdefault(family, {"kind": kinds.get(family, "untyped"),
                                      "help": helps.get(family, ""),
                                      "samples": {}})
        fam["samples"][(sample, key)] = value
    return out


def merge_prometheus_text(registry: Registry, text: str,
                          **extra_labels) -> Registry:
    """Fold a scraped exposition into ``registry``, adding
    ``extra_labels`` to every series (the orchestrator merges each worker's
    text under ``worker=<i>``). Counters and gauges merge by addition;
    histograms are rebuilt bucket for bucket (cumulative ``_bucket`` lines
    differenced back to per-bucket counts, ``_sum`` and ``_count``
    restored), so quantiles over the merged registry see every process's
    observations. Merging the same text twice counts it twice."""
    for family, fam in parse_prometheus_families(text).items():
        kind, help_, samples = fam["kind"], fam["help"], fam["samples"]
        if kind == "histogram":
            bounds = sorted({float(dict(key)["le"])
                             for (s, key) in samples
                             if s == f"{family}_bucket"
                             and not math.isinf(float(dict(key)["le"]))})
            if not bounds:
                continue
            h = registry.histogram(family, help_, buckets=bounds)
            series: Dict[LabelKey, Dict[float, float]] = {}
            sums: Dict[LabelKey, float] = {}
            counts_n: Dict[LabelKey, float] = {}
            for (sample, key), v in samples.items():
                if sample == f"{family}_bucket":
                    lab = dict(key)
                    le_raw = lab.pop("le")
                    le = math.inf if le_raw == "+Inf" else float(le_raw)
                    series.setdefault(_label_key(lab), {})[le] = v
                elif sample == f"{family}_sum":
                    sums[key] = v
                elif sample == f"{family}_count":
                    counts_n[key] = v
            for key, bucket_map in series.items():
                lab = dict(key)
                lab.update({k: str(v) for k, v in extra_labels.items()})
                dst = _label_key(lab)
                cum = [bucket_map.get(b, 0.0) for b in bounds]
                cum.append(bucket_map.get(math.inf, cum[-1]))
                per = [cum[0]] + [cum[i] - cum[i - 1]
                                  for i in range(1, len(cum))]
                with h._lock:
                    have = h._counts.setdefault(
                        dst, [0] * (len(h.buckets) + 1))
                    for i, c in enumerate(per):
                        have[i] += int(c)
                    h._n[dst] = h._n.get(dst, 0) + int(counts_n.get(key, 0))
                    h._series[dst] = h._series.get(dst, 0.0) \
                        + sums.get(key, 0.0)
            continue
        m = registry.counter(family, help_) if kind == "counter" \
            else registry.gauge(family, help_)
        for (sample, key), v in samples.items():
            lab = dict(key)
            lab.update({k: str(v2) for k, v2 in extra_labels.items()})
            m._add(v, lab)
    return registry
