"""Port copy of `repro.obs.metrics`, numpy only, with its imports renamed;
tests/test_torch_obs.py holds it to the reference.

Streaming metrics: counters, gauges, bounded-memory quantile histograms.

The registry is the observable substrate the actor refactor will shard
over, so every primitive is *mergeable by construction*:

  * Counter    — merge by sum (monotone, associative, commutative);
  * Gauge      — merge by sum by default (per-node partitions carry
                 disjoint label sets, so fleet gauges like queue depth
                 simply add up); `merge="max"` opts a family into
                 max-merge (e.g. high-water marks).  Both rules are
                 associative and commutative, so a sharded fleet's
                 registries fold in any order to the same bytes.
  * Histogram  — log-bucketed streaming histogram: a value v > 0 lands
                 in bucket floor(log_b(v)) for a fixed base b, so memory
                 is O(log(range)/log(b)) regardless of sample count, and
                 merging is per-bucket count addition.  Quantile queries
                 return the upper edge of the first bucket whose
                 cumulative count reaches the rank, so the estimate is
                 within one bucket (a factor of b) of the exact sample
                 percentile — the error bound tests/test_obs.py pins
                 against numpy on adversarial distributions.

Families are labeled (the cluster layer uses (node, model, phase) label
sets); children are created lazily on first `.labels(...)` touch and
exported in sorted label order, so `prometheus_text()` output is
deterministic for a deterministic run and invariant to merge order.

`prometheus_text()` emits the standard text exposition format (HELP/TYPE
comments, `name{label="value"} value` samples, histograms as cumulative
`_bucket{le=...}` + `_sum` + `_count`) — parseable by prometheus_client's
`text_string_to_metric_families` (asserted in tests) and scrapeable by an
actual Prometheus once a serving endpoint fronts it.

No wall-clock anywhere: values are driven purely by simulation state, so
two runs of the same seeded trace produce byte-identical exports (the
determinism contract the tracer tests rely on).
"""

from __future__ import annotations

import math
import re
from typing import Iterable, Sequence

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# default histogram bucket growth factor: 2**(1/8) ≈ 1.09, i.e. ~9%
# relative quantile resolution at ~8 buckets per octave (≈ 320 buckets
# spanning 1e-6 s .. 1e6 s — bounded memory at any sample count)
DEFAULT_BASE = 2.0 ** 0.125


def _fmt(v: float) -> str:
    """Prometheus sample value: integers without a trailing .0, floats via
    repr (shortest round-trip form; exposition format accepts exponents)."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape(value: str) -> str:
    return (value.replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


class Counter:
    """Monotone counter.  Merge rule: sum."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        self.value += amount

    def merge_from(self, other: "Counter") -> None:
        self.value += other.value


class Gauge:
    """Point-in-time value.  Merge rule: sum (default) or max — both
    associative, so sharded registries fold in any order."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount

    def merge_max_from(self, other: "Gauge") -> None:
        self.value = max(self.value, other.value)

    def merge_from(self, other: "Gauge") -> None:
        self.value += other.value


class Histogram:
    """Log-bucketed streaming histogram with bounded memory.

    Bucket i holds values in (base**i, base**(i+1)]; non-positive values
    land in a dedicated zero bucket (durations/energies are never
    negative, but the zero case is real: e.g. queue_s of an immediately
    served request).  Tracks count/sum/min/max exactly; quantiles are
    bucket-resolution estimates (within a factor of `base` of the exact
    sample percentile)."""

    __slots__ = ("base", "_log_base", "counts", "zero_count", "count",
                 "sum", "min", "max")

    def __init__(self, base: float = DEFAULT_BASE):
        if base <= 1.0:
            raise ValueError("histogram base must be > 1")
        self.base = base
        self._log_base = math.log(base)
        self.counts: dict[int, int] = {}
        self.zero_count = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= 0.0:
            self.zero_count += 1
            return
        # ceil(log_b(v)) - 1 == floor when not on an edge; the -1e-12 guard
        # keeps exact bucket edges (v == base**i) in the lower bucket
        i = math.floor(math.log(v) / self._log_base - 1e-12)
        self.counts[i] = self.counts.get(i, 0) + 1

    def quantile(self, q: float) -> float:
        """Upper edge of the first bucket whose cumulative count reaches
        rank q·count — within one bucket (factor `base`) of the exact
        sample percentile.  q in [0, 1]; empty histograms answer 0.0."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return 0.0
        rank = q * self.count
        cum = self.zero_count
        if cum >= rank:
            return 0.0
        for i in sorted(self.counts):
            cum += self.counts[i]
            if cum >= rank:
                # clamp to the exactly-tracked extremes so p0/p100-ish
                # queries never leave the observed range
                return min(max(self.base ** (i + 1), self.min), self.max)
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def merge_from(self, other: "Histogram") -> None:
        if other.base != self.base:
            raise ValueError("cannot merge histograms with different bases")
        for i, c in other.counts.items():
            self.counts[i] = self.counts.get(i, 0) + c
        self.zero_count += other.zero_count
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)


class MetricFamily:
    """One named metric with a fixed label schema and lazily-created
    children per label-value tuple."""

    def __init__(self, name: str, kind: str, help: str,
                 labelnames: Sequence[str], make_child, merge: str = "sum"):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        if merge not in ("sum", "max"):
            raise ValueError(f"merge must be 'sum' or 'max', got {merge!r}")
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self.merge = merge
        self._make_child = make_child
        self.children: dict[tuple[str, ...], object] = {}

    def labels(self, *values) -> object:
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected {len(self.labelnames)} label values "
                f"({self.labelnames}), got {len(values)}")
        key = tuple(str(v) for v in values)
        child = self.children.get(key)
        if child is None:
            child = self.children[key] = self._make_child()
        return child

    def get(self) -> object:
        """The unlabeled child (only valid for label-free families)."""
        return self.labels()

    def _label_str(self, key: tuple[str, ...],
                   extra: str = "") -> str:
        parts = [f'{n}="{_escape(v)}"' for n, v in zip(self.labelnames, key)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def sorted_children(self) -> Iterable[tuple[tuple[str, ...], object]]:
        return sorted(self.children.items())

    def merge_from(self, other: "MetricFamily") -> None:
        if (other.kind != self.kind or other.labelnames != self.labelnames
                or other.merge != self.merge):
            raise ValueError(
                f"family {self.name!r} schema mismatch on merge")
        for key, child in other.children.items():
            mine = self.children.get(key)
            if mine is None:
                mine = self.children[key] = self._make_child()
                if self.kind == "gauge" and self.merge == "max":
                    # A fresh Gauge starts at 0.0; max-merging against
                    # that floor would clobber negative values (the
                    # realized objective can be < 0), so a child absent
                    # on this side adopts the incoming value verbatim.
                    mine.value = child.value
                    continue
            if self.kind == "gauge" and self.merge == "max":
                mine.merge_max_from(child)
            else:
                mine.merge_from(child)


class MetricsRegistry:
    """Factory and container for metric families; the unit of sharding.

    `counter`/`gauge`/`histogram` are idempotent (same name → same family,
    with a schema check), so instrumented code can declare its metrics at
    the point of use.  `merge` folds another registry in (per-family,
    per-child, using each primitive's associative merge rule), which is
    how per-node partitions of a sharded fleet will aggregate."""

    def __init__(self):
        self._families: dict[str, MetricFamily] = {}

    # --- factories ----------------------------------------------------
    def _family(self, name: str, kind: str, help: str,
                labelnames: Sequence[str], make_child,
                merge: str = "sum") -> MetricFamily:
        fam = self._families.get(name)
        if fam is not None:
            if fam.kind != kind or fam.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} re-declared with a different schema: "
                    f"{fam.kind}{fam.labelnames} vs {kind}{tuple(labelnames)}")
            return fam
        fam = MetricFamily(name, kind, help, labelnames, make_child, merge)
        self._families[name] = fam
        return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> MetricFamily:
        return self._family(name, "counter", help, labelnames, Counter)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = (),
              merge: str = "sum") -> MetricFamily:
        return self._family(name, "gauge", help, labelnames, Gauge,
                            merge=merge)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  base: float = DEFAULT_BASE) -> MetricFamily:
        return self._family(name, "histogram", help, labelnames,
                            lambda: Histogram(base))

    # --- access -------------------------------------------------------
    def families(self) -> dict[str, MetricFamily]:
        return dict(self._families)

    def __contains__(self, name: str) -> bool:
        return name in self._families

    def __getitem__(self, name: str) -> MetricFamily:
        return self._families[name]

    def value(self, name: str, *labelvalues) -> float:
        """Convenience scalar read (counter/gauge value); 0.0 when the
        child was never touched."""
        fam = self._families[name]
        child = fam.children.get(tuple(str(v) for v in labelvalues))
        return 0.0 if child is None else child.value

    # --- merge --------------------------------------------------------
    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold `other` into self (in place; returns self).  Families
        missing on either side are unioned in; shared families merge
        child-wise under their associative rules."""
        for name, fam in other._families.items():
            mine = self._families.get(name)
            if mine is None:
                mine = self._families[name] = MetricFamily(
                    fam.name, fam.kind, fam.help, fam.labelnames,
                    fam._make_child, fam.merge)
            mine.merge_from(fam)
        return self

    @classmethod
    def merged(cls, registries: Sequence["MetricsRegistry"]
               ) -> "MetricsRegistry":
        out = cls()
        for r in registries:
            out.merge(r)
        return out

    # --- export -------------------------------------------------------
    def prometheus_text(self) -> str:
        """Standard Prometheus text exposition format (version 0.0.4)."""
        lines: list[str] = []
        for name in sorted(self._families):
            fam = self._families[name]
            if not fam.children:
                continue
            if fam.help:
                lines.append(f"# HELP {name} {_escape(fam.help)}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for key, child in fam.sorted_children():
                if fam.kind == "histogram":
                    cum = child.zero_count
                    if child.zero_count:
                        lab = fam._label_str(key, 'le="0"')
                        lines.append(f"{name}_bucket{lab} {cum}")
                    for i in sorted(child.counts):
                        cum += child.counts[i]
                        le = _fmt(child.base ** (i + 1))
                        lab = fam._label_str(key, f'le="{le}"')
                        lines.append(f"{name}_bucket{lab} {cum}")
                    lab = fam._label_str(key, 'le="+Inf"')
                    lines.append(f"{name}_bucket{lab} {child.count}")
                    lines.append(
                        f"{name}_sum{fam._label_str(key)} {_fmt(child.sum)}")
                    lines.append(
                        f"{name}_count{fam._label_str(key)} {child.count}")
                else:
                    lines.append(
                        f"{name}{fam._label_str(key)} {_fmt(child.value)}")
        return "\n".join(lines) + "\n" if lines else ""

    def to_dict(self) -> dict:
        """JSON-able snapshot (counters/gauges as scalars, histograms as
        count/sum/quantile summaries) — the benchmark dump format."""
        out: dict = {}
        for name in sorted(self._families):
            fam = self._families[name]
            fam_out: dict = {"kind": fam.kind, "labels": list(fam.labelnames),
                             "children": {}}
            for key, child in fam.sorted_children():
                tag = ",".join(key) if key else ""
                if fam.kind == "histogram":
                    fam_out["children"][tag] = {
                        "count": child.count, "sum": child.sum,
                        "min": None if child.count == 0 else child.min,
                        "max": None if child.count == 0 else child.max,
                        "p50": child.quantile(0.50),
                        "p95": child.quantile(0.95),
                        "p99": child.quantile(0.99),
                    }
                else:
                    fam_out["children"][tag] = child.value
            out[name] = fam_out
        return out
