"""Prometheus text exposition of the pod's snapshot trees (counterpart of
``modelx_tpu/utils/promexp.py``).

``/metrics`` keeps a JSON snapshot tree (nested dicts of counters and
gauges). This module renders the same tree as Prometheus text format 0.0.4
with ``# TYPE``/``# HELP`` comments, label escaping and explicit-bucket
histograms, selected by ``Accept: text/plain`` or
``/metrics?format=prometheus``. ``render`` is byte-identical to the JAX
package's on the same tree.

- ``Histogram``: a thread-safe fixed-bucket histogram whose ``snapshot()``
  is a plain JSON-able dict (cumulative bucket counts, sum and count); the
  continuous engine feeds its queue-time and time-to-first-token ones.
  The renderer recognizes the shape and emits ``_bucket``/``_sum``/
  ``_count`` series.
- ``render(tree, ...)``: a tree walk. Numeric leaves become gauges (keys
  ending ``_total`` become counters), histogram-shaped subtrees become
  histograms, and ``label_levels`` declares which dict levels hold dynamic
  keys (model names, device indices) that become label values instead of
  metric-name fragments. Strings, lists and None are skipped.
- ``wants_prometheus(accept, fmt)``: the content-negotiation rule.
"""

from __future__ import annotations

import math
import threading

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# latency-in-milliseconds buckets shared by the queue/prefill/ttft
# histograms: sub-ms admission waits through 30 s stragglers
DEFAULT_MS_BUCKETS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
    500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0,
)

_NAME_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:")


class Histogram:
    """Fixed explicit-bucket histogram. ``observe()`` is O(buckets) under
    one short lock; ``snapshot()`` returns the Prometheus-semantics view
    (CUMULATIVE bucket counts keyed by upper bound, plus sum and count)
    as a plain dict, so it embeds directly in the JSON snapshot trees."""

    __slots__ = ("_lock", "_bounds", "_counts", "_sum", "_count")

    def __init__(self, buckets=DEFAULT_MS_BUCKETS) -> None:
        bounds = sorted(float(b) for b in buckets)
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._lock = threading.Lock()
        self._bounds = tuple(bounds)
        self._counts = [0] * len(bounds)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        if math.isnan(v):
            return
        with self._lock:
            self._sum += v
            self._count += 1
            for i, bound in enumerate(self._bounds):
                if v <= bound:
                    self._counts[i] += 1
                    break

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            total, acc = self._count, self._sum
        buckets: dict[str, int] = {}
        running = 0
        for bound, n in zip(self._bounds, counts):
            running += n
            buckets[f"{bound:g}"] = running
        buckets["+Inf"] = total
        return {"buckets": buckets, "sum": acc, "count": total}


def is_histogram_snapshot(node) -> bool:
    """True when a subtree is the ``Histogram.snapshot()`` shape — the
    renderer's cue to emit ``_bucket``/``_sum``/``_count`` series."""
    return (
        isinstance(node, dict)
        and isinstance(node.get("buckets"), dict)
        and "sum" in node
        and "count" in node
    )


def wants_prometheus(accept, fmt) -> bool:
    """The one content-negotiation rule for every ``/metrics`` surface:
    an explicit ``?format=`` wins; otherwise ``Accept: text/plain``
    selects the exposition and anything else keeps the JSON default."""
    if fmt:
        return str(fmt).strip().lower() in ("prometheus", "text")
    return "text/plain" in str(accept or "").lower()


def escape_label_value(value) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def escape_help(text) -> str:
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _metric_name(parts) -> str:
    name = "_".join(parts)
    cleaned = "".join(c if c in _NAME_OK else "_" for c in name)
    if not cleaned:
        return "_"
    if cleaned[0].isdigit():
        cleaned = "_" + cleaned
    return cleaned


def _format_value(value) -> str:
    v = float(value)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _label_str(labels) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{escape_label_value(v)}"' for k, v in labels)
    return "{" + inner + "}"


def _walk(node, path, kpath, labels, label_levels, out) -> None:
    """Collect (name_parts, labels, kind, value) rows from a snapshot
    tree. ``label_levels`` maps a key path (tuple of ORIGINAL keys, with
    ``"*"`` standing for the dict level whose keys become label values)
    to a label name — how model names and pod URLs stay out of the
    metric namespace. ``kpath`` tracks the level-matching path: a
    consumed label level appends ``"*"`` there (but nothing to the
    metric-name ``path``), so a rule never re-matches on its children."""
    if is_histogram_snapshot(node):
        out.append((tuple(path), tuple(labels), "histogram", node))
        return
    if isinstance(node, bool):
        out.append((tuple(path), tuple(labels), "gauge", float(node)))
        return
    if isinstance(node, (int, float)):
        v = float(node)
        if not math.isnan(v):
            kind = "counter" if path and path[-1].endswith("_total") else "gauge"
            out.append((tuple(path), tuple(labels), kind, v))
        return
    if isinstance(node, dict):
        label_name = label_levels.get(tuple(kpath) + ("*",)) \
            if label_levels else None
        for key, val in node.items():
            if label_name is not None:
                _walk(val, path, kpath + ["*"],
                      labels + [(label_name, str(key))], label_levels, out)
            else:
                _walk(val, path + [str(key)], kpath + [str(key)],
                      labels, label_levels, out)
    # strings, lists, None: not representable as metrics — skipped, the
    # JSON surface keeps carrying them


def render(tree, *, namespace: str = "modelx", label_levels=None,
           help_prefix: str = "snapshot") -> str:
    """Render a snapshot tree as Prometheus text exposition.

    ``label_levels`` maps a path-with-wildcard tuple to a label name;
    ``{("*",): "model"}`` labels the TOP-level dynamic keys, and
    ``{("pods", "*"): "pod"}`` labels the keys under ``pods``. Rows that
    collapse onto the same metric name are grouped under one
    ``# TYPE``/``# HELP`` block (first kind wins; a kind clash demotes
    the family to gauge so the exposition always parses)."""
    levels = {}
    for raw_path, label in (label_levels or {}).items():
        levels[tuple(str(p) for p in raw_path)] = str(label)
    rows: list = []
    _walk(tree, [], [], [], levels, rows)

    families: dict[str, dict] = {}
    order: list[str] = []
    for path, labels, kind, value in rows:
        name = _metric_name((namespace,) + path)
        fam = families.get(name)
        if fam is None:
            fam = {"kind": kind, "samples": [], "path": path}
            families[name] = fam
            order.append(name)
        elif fam["kind"] != kind:
            fam["kind"] = "gauge"
        fam["samples"].append((labels, kind, value))

    lines: list[str] = []
    for name in order:
        fam = families[name]
        key = ".".join(fam["path"]) or namespace
        lines.append(f"# HELP {name} {escape_help(f'{help_prefix} key {key}')}")
        lines.append(f"# TYPE {name} {fam['kind']}")
        for labels, kind, value in fam["samples"]:
            if kind == "histogram" and fam["kind"] == "histogram":
                _render_histogram(lines, name, labels, value)
            elif kind == "histogram":
                # demoted family: surface only the count as a gauge
                lines.append(
                    f"{name}{_label_str(labels)} "
                    f"{_format_value(value.get('count', 0))}")
            else:
                lines.append(
                    f"{name}{_label_str(labels)} {_format_value(value)}")
    return "\n".join(lines) + "\n" if lines else ""


def _render_histogram(lines, name, labels, snap) -> None:
    buckets = snap.get("buckets") or {}
    seen_inf = False
    # bucket keys sort numerically with +Inf last; counts are already
    # cumulative in the snapshot shape
    def _bound(item):
        k = item[0]
        return math.inf if k == "+Inf" else float(k)

    for key, count in sorted(buckets.items(), key=_bound):
        if key == "+Inf":
            seen_inf = True
        le = list(labels) + [("le", key)]
        lines.append(f"{name}_bucket{_label_str(le)} {_format_value(count)}")
    if not seen_inf:
        le = list(labels) + [("le", "+Inf")]
        lines.append(
            f"{name}_bucket{_label_str(le)} "
            f"{_format_value(snap.get('count', 0))}")
    lines.append(f"{name}_sum{_label_str(labels)} "
                 f"{_format_value(snap.get('sum', 0.0))}")
    lines.append(f"{name}_count{_label_str(labels)} "
                 f"{_format_value(snap.get('count', 0))}")
