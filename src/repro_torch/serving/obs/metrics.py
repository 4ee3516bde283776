"""Copy of `repro.serving.obs.metrics` for the port.

Bounded-memory metrics registry with Prometheus text export.

Three metric types, all with O(1) memory per label set (no per-sample
retention — the registry is safe to leave enabled on an unbounded
serving run, unlike the telemetry event list):

  * ``Counter``   — monotonically increasing float (``inc``).
  * ``Gauge``     — instantaneous value, either pushed (``set``/``inc``)
    or pulled through a zero-hot-path-cost callback (``set_fn``)
    evaluated only at scrape/render time — how the engine exposes
    paged-pool occupancy and M_L queue depth without touching the
    decode loop.
  * ``Histogram`` — fixed-bucket distribution (cumulative bucket
    counts + sum + count, Prometheus semantics). Buckets are frozen at
    creation; observations never allocate.

Metrics are created through :class:`MetricsRegistry` (get-or-create by
name; re-registering a name with a different type/labels raises) and
rendered with :meth:`MetricsRegistry.render` in the Prometheus text
exposition format (v0.0.4) — served over HTTP by
``obs.httpd.MetricsServer`` or dumped to a file with ``write``.

All mutation is lock-protected: the threaded/stub M_L backends observe
batch metrics from their worker threads while the engine thread scrapes.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

# default latency buckets (seconds): micro-benchmark CPU decode steps sit
# around 1-50 ms; the tail covers slow M_L waits
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _fmt(v: float) -> str:
    """Prometheus sample value formatting: finite floats as repr
    ("1.0", "0.25"), infinities as +Inf/-Inf."""
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return repr(float(v))


def _fmt_labels(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    body = ",".join(f'{n}="{_escape(v)}"' for n, v in zip(names, values))
    return "{" + body + "}"


def _escape(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


class _Child:
    """One (labelset, value) cell of a counter/gauge family."""

    __slots__ = ("_lock", "_value", "_fn")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0.0                  # guarded_by: self._lock
        self._fn: Optional[Callable[[], float]] = None

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._value += v

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def set_fn(self, fn: Callable[[], float]) -> None:
        """Pull-mode gauge: `fn` is evaluated at render/scrape time only,
        so registering one adds zero cost to the instrumented hot path."""
        self._fn = fn

    @property
    def value(self) -> float:
        if self._fn is not None:
            return float(self._fn())
        with self._lock:
            return self._value


class _HistChild:
    """One labelset cell of a histogram family: cumulative fixed-bucket
    counts + sum + count (Prometheus semantics, bounded memory)."""

    __slots__ = ("_lock", "buckets", "counts", "sum", "count")

    def __init__(self, lock: threading.Lock, buckets: Tuple[float, ...]):
        self._lock = lock
        self.buckets = buckets
        # cumulative state (last bucket = +Inf)
        self.counts = [0] * (len(buckets) + 1)  # guarded_by: self._lock
        self.sum = 0.0                     # guarded_by: self._lock
        self.count = 0                     # guarded_by: self._lock

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        for i, ub in enumerate(self.buckets):     # noqa: B007
            if v <= ub:
                break
        else:
            i = len(self.buckets)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    def cumulative(self) -> List[int]:
        return self.snapshot()[0]

    def snapshot(self) -> Tuple[List[int], float, int]:
        """(cumulative bucket counts, sum, count) read atomically — the
        renderer must not see a count from one observation and a sum
        from the next."""
        with self._lock:
            out, acc = [], 0
            for c in self.counts:
                acc += c
                out.append(acc)
            return out, self.sum, self.count


class MetricFamily:
    """A named metric plus its labeled children. With no label names the
    family itself is the single child (``family.inc(...)`` etc. work
    directly); with label names, address cells via ``labels(...)``."""

    def __init__(self, name: str, help_: str, mtype: str,
                 labelnames: Tuple[str, ...] = (),
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help_
        self.type = mtype
        self.labelnames = labelnames
        self.buckets = tuple(buckets)
        self._lock = threading.Lock()
        # NOTE: children share this lock — never read a child's value
        # while holding it (collect under lock, read outside)
        self._children: Dict[Tuple[str, ...], object] = {}  # guarded_by: self._lock
        if not labelnames:
            self._default = self._make_child()
            self._children[()] = self._default
        else:
            self._default = None

    def _make_child(self):
        if self.type == "histogram":
            return _HistChild(self._lock, self.buckets)
        return _Child(self._lock)

    def labels(self, **kv) -> object:
        if set(kv) != set(self.labelnames):
            raise ValueError(f"{self.name}: expected labels "
                             f"{self.labelnames}, got {tuple(kv)}")
        key = tuple(str(kv[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
            return child

    # -- unlabeled convenience --------------------------------------------
    def _only(self):
        if self._default is None:
            raise ValueError(f"{self.name} is labeled "
                             f"{self.labelnames}: use .labels(...)")
        return self._default

    def inc(self, v: float = 1.0) -> None:
        self._only().inc(v)

    def set(self, v: float) -> None:
        self._only().set(v)

    def set_fn(self, fn: Callable[[], float]) -> None:
        self._only().set_fn(fn)

    def observe(self, v: float) -> None:
        self._only().observe(v)

    @property
    def value(self) -> float:
        return self._only().value

    # -- rendering ---------------------------------------------------------
    def render(self) -> str:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.type}")
        with self._lock:
            children = sorted(self._children.items())
        for key, child in children:   # child reads re-take the lock
            if self.type == "histogram":
                cum, total, count = child.snapshot()
                for ub, c in zip((*self.buckets, float("inf")), cum):
                    lbl = _fmt_labels((*self.labelnames, "le"),
                                      (*key, _fmt(ub)))
                    lines.append(f"{self.name}_bucket{lbl} {c}")
                base = _fmt_labels(self.labelnames, key)
                lines.append(f"{self.name}_sum{base} {_fmt(total)}")
                lines.append(f"{self.name}_count{base} {count}")
            else:
                lbl = _fmt_labels(self.labelnames, key)
                lines.append(f"{self.name}{lbl} {_fmt(child.value)}")
        return "\n".join(lines)


class MetricsRegistry:
    """Get-or-create registry of metric families + Prometheus renderer.

    Re-requesting an existing name returns the same family; asking for it
    with a different type or label names raises (catches silent metric
    collisions between subsystems)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, MetricFamily] = {}  # guarded_by: self._lock

    def _get(self, name: str, help_: str, mtype: str,
             labels: Iterable[str], buckets=DEFAULT_BUCKETS) -> MetricFamily:
        labels = tuple(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.type != mtype or fam.labelnames != labels:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.type}{fam.labelnames}, requested "
                        f"{mtype}{labels}")
                return fam
            fam = MetricFamily(name, help_, mtype, labels, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help_: str = "",
                labels: Iterable[str] = ()) -> MetricFamily:
        return self._get(name, help_, "counter", labels)

    def gauge(self, name: str, help_: str = "",
              labels: Iterable[str] = (),
              fn: Optional[Callable[[], float]] = None) -> MetricFamily:
        fam = self._get(name, help_, "gauge", labels)
        if fn is not None:
            fam.set_fn(fn)
        return fam

    def histogram(self, name: str, help_: str = "",
                  labels: Iterable[str] = (),
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS
                  ) -> MetricFamily:
        return self._get(name, help_, "histogram", labels, buckets)

    def get(self, name: str) -> Optional[MetricFamily]:
        with self._lock:
            return self._families.get(name)

    def snapshot(self) -> Dict[str, Dict[Tuple[str, ...], float]]:
        """Point-in-time ``{family: {label-values: value}}`` view of
        every counter and gauge (histograms are excluded — ``render()``
        reports their buckets). The no-parse alternative to scraping
        the text exposition: tests and overload-control assertions read
        e.g. ``snapshot()["serving_requests_total"][("rejected",)]``
        instead of regexing the Prometheus dump."""
        with self._lock:
            fams = list(self._families.values())
        out: Dict[str, Dict[Tuple[str, ...], float]] = {}
        for fam in fams:
            if fam.type == "histogram":
                continue
            with fam._lock:
                children = sorted(fam._children.items())
            # .value re-takes the (non-reentrant) family lock
            out[fam.name] = {key: child.value for key, child in children}
        return out

    def render(self) -> str:
        """Prometheus text exposition format (v0.0.4), families sorted by
        name, trailing newline included (scrapers require it)."""
        with self._lock:
            fams = [self._families[n] for n in sorted(self._families)]
        parts = [f.render() for f in fams]
        return "\n".join(parts) + ("\n" if parts else "")

    def write(self, path: str) -> None:
        """Dump the current scrape to a file (the no-HTTP export path)."""
        import os
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            f.write(self.render())
