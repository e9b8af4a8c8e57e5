"""Operator entry point for serving telemetry (DESIGN.md §15).

Counterpart of `repro.obs.snapshot`: plain Python, copied with the
imports renamed and the decisions kept the same.

    PYTHONPATH=src python -m repro_torch.obs.snapshot trace.jsonl
    PYTHONPATH=src python -m repro_torch.obs.snapshot trace.jsonl --chrome t.json
    PYTHONPATH=src python -m repro_torch.obs.snapshot trace.jsonl --json

Reads a JSONL trace (`ServerConfig(trace="trace.jsonl")`, or
`TraceRecorder.write_jsonl`) and prints the operator roll-up: event
counts, span/terminal accounting (every submitted request must show
exactly one fulfil/shed/fail), and per-bucket queue-wait and dispatch
extents. `--chrome` additionally converts the trace to Chrome
trace-event JSON -- open the output at https://ui.perfetto.dev to see
one track per bucket with queued/dispatch slices per request. `--json`
dumps the machine-readable summary instead of the table.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.trace import TERMINALS, TraceRecorder


def load_jsonl(path: str) -> list[dict]:
    """Parse one event dict per line; blank/corrupt lines are skipped
    (a crash mid-write must not make the whole trace unreadable)."""
    events = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(ev, dict) and "event" in ev and "ts" in ev:
                events.append(ev)
    return events


def render(summary: dict) -> str:
    """The human table: counts, terminal accounting, per-bucket extents."""
    lines = [f"{'event':<12} count"]
    for name, n in sorted(summary["events"].items()):
        lines.append(f"{name:<12} {n}")
    term = summary["terminals"]
    total = sum(term.values())
    lines.append("")
    lines.append(f"spans: {summary['spans']}  terminals: {total} ("
                 + ", ".join(f"{k}={term[k]}" for k in TERMINALS)
                 + f")  dropped: {summary['dropped']}")
    if summary["spans"] and total != summary["spans"]:
        lines.append(f"WARNING: {summary['spans']} spans but {total} "
                     "terminal events -- the trace is incomplete or a "
                     "request was double-terminated")
    for title, key in (("queue wait", "queue_wait_s"),
                       ("dispatch", "dispatch_s")):
        rows = summary[key]
        if not rows:
            continue
        lines.append("")
        lines.append(f"{title} per bucket (ms):")
        for bucket, ext in sorted(rows.items()):
            lines.append(f"  {bucket:<48} n={ext['n']:<4} "
                         f"mean={ext['mean']*1e3:8.2f} "
                         f"min={ext['min']*1e3:8.2f} "
                         f"max={ext['max']*1e3:8.2f}")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.snapshot",
        description="Summarize a serving trace (DESIGN.md §15)")
    ap.add_argument("trace", help="JSONL trace file (ServerConfig trace=)")
    ap.add_argument("--chrome", metavar="OUT",
                    help="also write Chrome trace-event JSON (Perfetto)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="print the machine-readable summary")
    args = ap.parse_args(argv)

    events = load_jsonl(args.trace)
    if not events:
        print(f"no events in {args.trace}", file=sys.stderr)
        return 1
    rec = TraceRecorder.from_events(events)
    if args.chrome:
        n = rec.write_chrome(args.chrome)
        print(f"wrote {n} trace slices to {args.chrome} "
              "(open in https://ui.perfetto.dev)", file=sys.stderr)
    summary = rec.summary()
    print(json.dumps(summary, indent=2, default=str) if args.as_json
          else render(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
