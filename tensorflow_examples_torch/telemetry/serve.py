"""Prometheus text rendering of a metrics registry and RFC-8259-safe JSON
(the parts of ``tensorflow_examples_tpu/telemetry/serve.py`` the serving
frontend needs)."""

from __future__ import annotations

import math
import re

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
# A histogram rendered as a Prometheus summary exposes these quantiles.
_QUANTILES = ((50, "0.5"), (95, "0.95"), (99, "0.99"))


def json_safe(obj):
    """Non-finite floats -> null, recursively (``json.dumps`` would emit
    literal ``NaN`` tokens, which strict JSON consumers reject)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    return obj


def sanitize_metric_name(name: str) -> str:
    """Registry name -> Prometheus metric name (``a/b-c`` -> ``a_b_c``; a
    leading digit gets an underscore prefix)."""
    out = _NAME_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out or "_"


def _fmt_value(v: float) -> str:
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f)


def render_prometheus(registry, *, host: int = 0) -> str:
    """The registry in Prometheus text exposition format 0.0.4: counters
    and gauges as samples, time histograms as summaries with p50/p95/p99
    quantiles, ``_sum`` and ``_count`` (names gain ``_seconds``)."""
    label = f'{{host="{int(host)}"}}'
    lines: list[str] = []
    for name, value in sorted(registry.counter_values().items()):
        n = sanitize_metric_name(name)
        lines += [f"# TYPE {n} counter", f"{n}{label} {_fmt_value(value)}"]
    for name, value in sorted(registry.gauge_values().items()):
        n = sanitize_metric_name(name)
        lines += [f"# TYPE {n} gauge", f"{n}{label} {_fmt_value(value)}"]
    for name, summary in sorted(registry.histogram_summaries().items()):
        if not summary["count"]:
            continue
        n = sanitize_metric_name(name) + "_seconds"
        lines.append(f"# TYPE {n} summary")
        for q, q_label in _QUANTILES:
            v = summary[f"p{q}"]
            if v is not None:
                lines.append(
                    f'{n}{{host="{int(host)}",quantile="{q_label}"}} {_fmt_value(v)}'
                )
        lines.append(f"{n}_sum{label} {_fmt_value(summary['total'])}")
        lines.append(f"{n}_count{label} {_fmt_value(summary['count'])}")
    return "\n".join(lines) + "\n"
