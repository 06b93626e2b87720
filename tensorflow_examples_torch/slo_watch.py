"""Terminal SLO watcher: poll a router's /alerts + /series. The port of
``tools/slo_watch.py``, with the same flags, output and exit codes; it
reads through the port's router client and imports nothing of the JAX
package, so it runs where there is no JAX.

    python -m tensorflow_examples_torch.slo_watch http://127.0.0.1:9000          # loop
    python -m tensorflow_examples_torch.slo_watch http://127.0.0.1:9000 --once   # one poll

Every poll renders the AlertEngine's live state: each rule's fast/slow
burn rates and budget remaining, plus every FIRING alert with its
severity and worst-offender exemplar, so the responder's next command
is a copy-paste:

    FIRING ttft_interactive [page] burn 14.2x/3.1x budget 12% left
      -> python tools/trace_report.py traces.jsonl --trace-id tr-ab12..

and a compact tail of the time-series ring (``GET /series`` rollups)
for the instruments behind the burn.

Exit code is the script contract: ``--once`` (and a loop ended by
``--polls N``) exits **1 while any alert is firing**, 0 when healthy,
2 when the endpoint is unreachable, so a deploy pipeline can gate a
rollout step on ``slo_watch --once``. A looping watch that loses the
endpoint after a healthy poll reports "endpoint gone" and exits with
the last poll's verdict (the run ended; its alerts are the verdict).

Works against the router frontend (fleet view: organic traffic and
canary probes) and any replica frontend's ``/series`` (``/alerts`` is
router-side).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from tensorflow_examples_torch.serving.router import _get_json

# Series rendered in the --series tail when present (the instruments
# the default SLO rules burn on), before any --series matches.
_DEFAULT_SERIES = (
    "router/e2e.p95",
    "router/requests_total",
    "probe/ttft.p95",
    "probe/failed_total",
)


def fetch(base: str, timeout: float) -> tuple[dict | None, dict | None]:
    """(alerts payload, series payload); either may be None (a replica
    frontend serves /series but not /alerts; a gone endpoint neither)."""
    status, alerts = _get_json(base + "/alerts", timeout)
    if status != 200 or not isinstance(alerts, dict):
        alerts = None
    status, series = _get_json(base + "/series", timeout)
    if status != 200 or not isinstance(series, dict):
        series = None
    return alerts, series


def render(alerts: dict | None, series: dict | None,
           series_names: list[str]) -> tuple[str, int]:
    """(text, firing count) for one poll."""
    out = []
    firing = 0
    if alerts is not None:
        firing = int(alerts.get("alerts_firing", 0))
        out.append(f"slo: {firing} firing, budget remaining "
                   f"{alerts.get('error_budget_remaining', 1.0):.1%}, probe success "
                   f"{alerts.get('probe_success_rate', 1.0):.1%}, "
                   f"{alerts.get('alert_count', 0)} fired total")
        for name, rule in sorted((alerts.get("rules") or {}).items()):
            state = rule.get("state")
            mark = "FIRING" if state == "firing" else "pending" if state == "pending" else "ok"
            out.append(f"  {mark:<7} {name:<24} burn {rule.get('burn_rate_fast', 0.0):.1f}x/"
                       f"{rule.get('burn_rate_slow', 0.0):.1f}x  budget "
                       f"{rule.get('budget_remaining', 1.0):.1%}")
        for a in alerts.get("firing") or []:
            line = (f"FIRING {a.get('name')} [{a.get('severity')}] slo={a.get('slo')} burn "
                    f"{a.get('burn_rate', 0.0):.1f}x")
            if a.get("replica"):
                line += f" replica={a['replica']}"
            out.append(line)
            if a.get("trace_id"):
                out.append("  -> python tools/trace_report.py <traces.jsonl> "
                           f"--trace-id {a['trace_id']}")
    if series is not None:
        rollups = series.get("rollups") or {}
        names = [n for n in _DEFAULT_SERIES if n in rollups]
        names += [n for n in sorted(rollups)
                  if any(pat in n for pat in series_names) and n not in names]
        for n in names:
            r = rollups[n]
            out.append(f"  series {n:<28} last={r.get('last')} p50={r.get('p50')} "
                       f"p95={r.get('p95')} p99={r.get('p99')} n={r.get('count')}")
    return "\n".join(out), firing


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("endpoint", help="router (or replica) frontend base URL, e.g. "
                                     "http://127.0.0.1:9000")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="seconds between polls (loop mode)")
    ap.add_argument("--once", action="store_true", help="one poll, then exit (1 while firing)")
    ap.add_argument("--polls", type=int, default=0, help=">0: stop after N polls (loop mode)")
    ap.add_argument("--timeout", type=float, default=5.0, help="per-GET timeout (seconds)")
    ap.add_argument("--series", action="append", default=[], metavar="SUBSTR",
                    help="also render /series rollups whose name contains SUBSTR (repeatable)")
    ap.add_argument("--json", action="store_true",
                    help="emit the raw /alerts payload per poll instead of the rendered view")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    base = args.endpoint.rstrip("/")
    if "://" not in base:
        base = "http://" + base
    last_firing = 0
    seen_healthy = False
    polls = 0
    while True:
        alerts, series = fetch(base, args.timeout)
        if alerts is None and series is None:
            if seen_healthy:
                print("endpoint gone: run ended", file=sys.stderr)
                return 1 if last_firing else 0
            print(f"unreachable: {base}", file=sys.stderr)
            return 2
        seen_healthy = True
        if args.json:
            print(json.dumps(alerts if alerts is not None else series))
            last_firing = int((alerts or {}).get("alerts_firing", 0))
        else:
            text, last_firing = render(alerts, series, args.series)
            print(f"-- {time.strftime('%H:%M:%S')} {base}")
            print(text)
        sys.stdout.flush()
        polls += 1
        if args.once or (args.polls and polls >= args.polls):
            return 1 if last_firing else 0
        time.sleep(args.interval)


if __name__ == "__main__":
    sys.exit(main())
