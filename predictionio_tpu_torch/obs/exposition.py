"""Metric exposition (counterpart of ``predictionio_tpu/obs/exposition.py``,
whose text it renders byte for byte): Prometheus text format, a parser for it (the CLI
pretty-printer and bench scrapes reuse one implementation), and the
reference-parity ``stats.json`` window collector.

The reference's EventServerStats (``--stats`` flag) kept per-(appId,
statusCode, event) counters in two views — since server start and a
rolling current window — served at ``GET /stats.json``.
:class:`StatsCollector` reproduces that: ``record()`` lands in both the
since-start and the current-window map; when the window (default 60 s,
``PIO_STATS_WINDOW_S``) elapses, the current map is published as the
last completed window and a fresh one starts.
"""

from __future__ import annotations

import datetime as _dt
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from predictionio_tpu_torch.obs import metrics as _metrics


# -- Prometheus text format ---------------------------------------------------

def _fmt_value(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _series_line(name: str, labels: str, value: float,
                 extra_label: str = "") -> str:
    body = ",".join(x for x in (labels, extra_label) if x)
    if body:
        return f"{name}{{{body}}} {_fmt_value(value)}"
    return f"{name} {_fmt_value(value)}"


def render_prometheus(snapshot: dict) -> str:
    """Prometheus text exposition (v0.0.4) of a registry snapshot (or a
    cross-worker merge of snapshots)."""
    lines: List[str] = []
    for name in sorted(snapshot):
        entry = snapshot[name]
        lines.append(f"# HELP {name} {entry['help']}")
        lines.append(f"# TYPE {name} {entry['type']}")
        series = entry["series"]
        if entry["type"] == "histogram":
            buckets = entry["buckets"]
            for key in sorted(series):
                s = series[key]
                cum = 0
                for le, n in zip(buckets, s["counts"]):
                    cum += n
                    lines.append(_series_line(
                        name + "_bucket", key, cum, f'le="{_fmt_value(le)}"'))
                inf_line = _series_line(
                    name + "_bucket", key, s["count"], 'le="+Inf"')
                ex = s.get("ex")
                if ex:
                    # OpenMetrics-style exemplar on the +Inf bucket: the
                    # trace id of the max-latency observation in the
                    # current exemplar window — the metrics→traces link.
                    # The middleware only honors [A-Za-z0-9._:-] request
                    # ids, but escape label-style anyway: a programmatic
                    # observe(exemplar=...) caller is not so constrained
                    rid = (str(ex[1]).replace("\\", "\\\\")
                           .replace('"', '\\"').replace("\n", "\\n"))
                    inf_line += (' # {trace_id="%s"} %s %s'
                                 % (rid, _fmt_value(ex[0]),
                                    _fmt_value(ex[2])))
                lines.append(inf_line)
                lines.append(_series_line(name + "_sum", key, s["sum"]))
                lines.append(_series_line(name + "_count", key, s["count"]))
        else:
            for key in sorted(series):
                lines.append(_series_line(name, key, series[key]))
    return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str):
    """Parse Prometheus text into ``(families, types)``:

    - families: {line_name: [(labels_dict, value), ...]} where line_name
      keeps the ``_bucket``/``_sum``/``_count`` suffixes literal;
    - types: {metric_name: "counter"|"gauge"|"histogram"}.
    """
    families: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    types: Dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        if " # {" in line:
            # strip the OpenMetrics exemplar suffix (see parse_exemplars
            # for reading it); a label VALUE containing ' # {' would be
            # truncated here — our own label escaping never produces one
            line = line.split(" # {", 1)[0]
        try:
            if "{" in line:
                name, rest = line.split("{", 1)
                body, value_s = rest.rsplit("}", 1)
                labels: Dict[str, str] = {}
                for part in _split_label_body(body):
                    k, _, v = part.partition("=")
                    if len(v) >= 2 and v[0] == '"' and v[-1] == '"':
                        v = v[1:-1]
                    labels[k] = _unescape_label_value(v)
            else:
                name, value_s = line.rsplit(None, 1)
                labels = {}
            families.setdefault(name.strip(), []).append(
                (labels, float(value_s)))
        except ValueError:
            continue  # tolerate exposition lines we didn't write
    return families, types


def _unescape_label_value(s: str) -> str:
    """Inverse of metrics._label_key's escaping.  A single left-to-right
    scan, NOT chained str.replace: sequential replaces process '\\\\n'
    (escaped backslash + literal n) in the wrong order and corrupt it
    into a newline."""
    if "\\" not in s:
        return s
    out: List[str] = []
    i, n = 0, len(s)
    while i < n:
        c = s[i]
        if c == "\\" and i + 1 < n:
            nxt = s[i + 1]
            if nxt == "\\" or nxt == '"':
                out.append(nxt)
                i += 2
                continue
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


def _split_label_body(body: str) -> List[str]:
    """Split 'a="x",b="y,z"' on commas outside quotes."""
    parts, cur, in_q, esc = [], [], False, False
    for ch in body:
        if esc:
            cur.append(ch)
            esc = False
            continue
        if ch == "\\":
            cur.append(ch)
            esc = True
            continue
        if ch == '"':
            in_q = not in_q
            cur.append(ch)
            continue
        if ch == "," and not in_q:
            parts.append("".join(cur))
            cur = []
            continue
        cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return [p for p in (s.strip() for s in parts) if p]


def parse_exemplars(text: str) -> Dict[str, List[Tuple[Dict[str, str],
                                                       str, float]]]:
    """Extract the exemplars render_prometheus attaches to ``+Inf``
    bucket lines: ``{line_name: [(labels, trace_id, value), ...]}``."""
    out: Dict[str, List[Tuple[Dict[str, str], str, float]]] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if line.startswith("#") or " # {" not in line:
            continue
        main, _, ex = line.partition(" # {")
        body, _, tail = ex.partition("}")
        k, _, v = body.partition("=")
        if k.strip() != "trace_id":
            continue
        trace_id = v.strip().strip('"')
        try:
            ex_value = float(tail.split()[0])
        except (ValueError, IndexError):
            continue
        try:
            name = main.split("{", 1)[0]
            fams, _t = parse_prometheus_text(main)
            labels = fams[name][0][0]
        except (KeyError, IndexError):
            continue
        out.setdefault(name, []).append((labels, trace_id, ex_value))
    return out


def family_total(families: dict, name: str,
                 **match: str) -> float:
    """Sum every series of ``name`` whose labels include ``match``."""
    total = 0.0
    for labels, value in families.get(name, ()):
        if all(labels.get(k) == v for k, v in match.items()):
            total += value
    return total


def _quantile_from_buckets(buckets: List[Tuple[float, float]],
                           total: float, q: float) -> float:
    """Estimate a quantile from cumulative (le, count) pairs by
    midpoint-rank interpolation inside the winning bucket: the r-th of m
    observations in a bucket sits at fraction (r − ½)/m of its width.
    The old target/cum ratio degenerated to the bucket's UPPER bound for
    high quantiles of a sparsely-hit bucket (a single observation
    reported p99 ≈ le, overstating the measured latency by up to a whole
    log-scaled bucket)."""
    import math

    target = q * total
    prev_le, prev_cum = 0.0, 0.0
    for le, cum in buckets:
        if cum >= target:
            if le == float("inf"):
                return prev_le
            m = cum - prev_cum
            if m <= 0:
                return prev_le
            # the quantile falls on the r-th observation in this bucket
            r = max(math.ceil(target - prev_cum), 1)
            frac = min(max((r - 0.5) / m, 0.0), 1.0)
            return prev_le + (le - prev_le) * frac
        prev_le, prev_cum = le, cum
    return prev_le


def summarize_prometheus(text: str) -> str:
    """Human-readable digest of a /metrics payload for `pio metrics`:
    counters/gauges per series; histograms as count/sum/avg and
    bucket-interpolated p50/p95/p99."""
    families, types = parse_prometheus_text(text)
    out: List[str] = []
    hist_names = sorted(n for n, t in types.items() if t == "histogram")
    plain = sorted(n for n, t in types.items() if t in ("counter", "gauge"))
    for name in plain:
        out.append(f"{name} ({types[name]})")
        for labels, value in sorted(
                families.get(name, ()), key=lambda lv: sorted(lv[0].items())):
            lbl = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
            out.append(f"  {lbl or '(no labels)':60s} {_fmt_value(value)}")
    for name in hist_names:
        out.append(f"{name} (histogram)")
        # group bucket series by their non-le labels
        groups: Dict[str, List[Tuple[float, float]]] = {}
        for labels, value in families.get(name + "_bucket", ()):
            le = labels.get("le", "")
            rest = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items())
                            if k != "le")
            groups.setdefault(rest, []).append(
                (float("inf") if le == "+Inf" else float(le), value))
        for rest in sorted(groups):
            buckets = sorted(groups[rest])
            count = next((v for lb, v in families.get(name + "_count", ())
                          if ",".join(f'{k}="{x}"' for k, x in
                                      sorted(lb.items())) == rest), 0.0)
            total = next((v for lb, v in families.get(name + "_sum", ())
                          if ",".join(f'{k}="{x}"' for k, x in
                                      sorted(lb.items())) == rest), 0.0)
            if count <= 0:
                continue
            p50 = _quantile_from_buckets(buckets, count, 0.50)
            # clamp p50 ≤ p95 ≤ p99: per-bucket interpolation of a sparse
            # histogram can otherwise invert adjacent quantiles
            p95 = max(_quantile_from_buckets(buckets, count, 0.95), p50)
            p99 = max(_quantile_from_buckets(buckets, count, 0.99), p95)
            out.append(
                f"  {rest or '(no labels)':40s} count={_fmt_value(count)} "
                f"sum={total:.4g} avg={total / count:.4g} "
                f"p50≈{p50:.4g} p95≈{p95:.4g} p99≈{p99:.4g}")
    return "\n".join(out) + "\n"


def metrics_payload() -> bytes:
    """The ``GET /metrics`` body: cross-worker aggregate in Prometheus
    text format."""
    return render_prometheus(_metrics.aggregate_snapshot()).encode()


# -- stats.json ---------------------------------------------------------------

def _stats_window_s() -> float:
    try:
        return max(float(os.environ.get("PIO_STATS_WINDOW_S", "60")), 0.1)
    except ValueError:
        return 60.0


class StatsCollector:
    """Reference-parity EventServerStats: per-(appId, status,
    entityType/event) counters in a since-start view and a rolling
    current window (plus the last COMPLETED window, the stable
    per-interval rate view)."""

    def __init__(self, window_s: Optional[float] = None):
        self.window_s = window_s if window_s is not None else _stats_window_s()
        self.start_time = _dt.datetime.now(_dt.timezone.utc)
        self._lock = threading.Lock()
        self._since_start: Dict[tuple, int] = {}
        self._current: Dict[tuple, int] = {}
        self._last_window: Dict[tuple, int] = {}
        # lazily anchored to the first observed clock value, so an
        # injected test clock and the real monotonic clock both work
        self._window_start: Optional[float] = None
        self._window_start_dt = self.start_time

    def record(self, app_id: Optional[int], status: int,
               event: Optional[str] = None,
               entity_type: Optional[str] = None,
               now: Optional[float] = None) -> None:
        key = (app_id, int(status), event, entity_type)
        now = time.monotonic() if now is None else now
        with self._lock:
            self._roll_locked(now)
            self._since_start[key] = self._since_start.get(key, 0) + 1
            self._current[key] = self._current.get(key, 0) + 1

    def _roll_locked(self, now: float) -> None:
        if self._window_start is None:
            self._window_start = now
            return
        elapsed = now - self._window_start
        if elapsed >= self.window_s:
            # 'last window' means the window ADJACENT to now: after an
            # idle gap spanning multiple windows the just-completed one
            # was empty — publishing the pre-gap counts would report an
            # arbitrarily old burst as the current rate
            self._last_window = (
                self._current if elapsed < 2 * self.window_s else {})
            self._current = {}
            self._window_start = now
            self._window_start_dt = _dt.datetime.now(_dt.timezone.utc)

    @staticmethod
    def _entries(counts: Dict[tuple, int],
                 app_id: Optional[int]) -> List[dict]:
        out = []
        for (aid, status, event, etype), n in sorted(
                counts.items(), key=lambda kv: repr(kv[0])):
            if app_id is not None and aid != app_id:
                continue
            e: dict = {"status": status, "count": n}
            if aid is not None:
                e["appId"] = aid
            if event is not None:
                e["event"] = event
            if etype is not None:
                e["entityType"] = etype
            out.append(e)
        return out

    def to_json(self, app_id: Optional[int] = None,
                now: Optional[float] = None) -> dict:
        """``app_id`` filters the views to one app (the event server's
        authenticated response); None exposes everything."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._roll_locked(now)
            return {
                "startTime": self.start_time.isoformat(),
                "window": {
                    "start": self._window_start_dt.isoformat(),
                    "seconds": self.window_s,
                },
                "statsSinceStart": self._entries(self._since_start, app_id),
                "statsCurrent": self._entries(self._current, app_id),
                "statsLastWindow": self._entries(self._last_window, app_id),
            }
