"""Offline solve-trace and flight-record tooling: a copy of the reference
package's ``kao-trace``, run as
``python -m kafka_assignment_optimizer_tpu_torch.obs.trace_cli``
(``kao-trace`` below).

Subcommands:

``kao-trace convert REPORT.json [-o OUT.json]``
    Convert a solve report to Chrome trace-event JSON (loadable in
    ``chrome://tracing`` / Perfetto). Accepts a bare solve report, a
    CLI ``--trace`` stderr report (the ``solve_report`` field is
    extracted), or a saved ``GET /debug/solves/<id>`` response.

``kao-trace fetch --url http://host:port [TRACE_ID] [--chrome] [-o F]``
    List the server's retrievable trace IDs, or fetch one report —
    converted to Chrome trace JSON with ``--chrome``.

``kao-trace flight PATH [--tail N] [--kind K] [--follow [--max N]]``
    Dump flight records (one JSON line each) from a flight JSONL file
    or a ``--flight-dir`` directory (archives first, then the live
    file). Torn/corrupt lines are skipped, matching the recorder's
    crash-safety contract. Records carry the worker identity stamp
    (host/pid/port/boot) and per-worker ``seq`` the fleet merge keys
    on. ``--follow`` tails the LIVE file like ``tail -f``, surviving
    the recorder's atomic rotation (the archived file is drained
    before the fresh live file is opened from its start — no record
    is ever printed twice or skipped); ``--max N`` exits after N
    followed records (tests/pipelines), Ctrl-C exits 0.

Exit codes: 0 ok, 2 usage/input error, 3 not found.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _load_report(path: str) -> dict:
    doc = json.loads(Path(path).read_text())
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: expected a JSON object")
    # a CLI --trace report wraps the solve report; unwrap transparently
    if "spans" not in doc and isinstance(doc.get("solve_report"), dict):
        doc = doc["solve_report"]
    if "spans" not in doc:
        raise ValueError(
            f"{path}: no span tree — not a solve report (want the JSON "
            "from GET /debug/solves/<id> or a --trace report)"
        )
    return doc


def _write(text: str, out: str | None) -> None:
    if out:
        Path(out).write_text(text + "\n")
    else:
        # kao: disable=KAO106 -- the converted JSON on stdout IS the product
        print(text)


def _cmd_convert(args) -> int:
    from .chrome import report_to_json

    rep = _load_report(args.report)
    _write(report_to_json(rep, indent=args.indent), args.output)
    return 0


def _cmd_fetch(args) -> int:
    import urllib.error
    import urllib.request

    base = args.url.rstrip("/")
    path = "/debug/solves" + (f"/{args.trace_id}" if args.trace_id else "")
    try:
        with urllib.request.urlopen(base + path, timeout=30) as r:
            doc = json.loads(r.read())
    except urllib.error.HTTPError as e:
        # kao: disable=KAO106 -- "error: ..." on stderr is the CLI's UX contract
        print(f"error: {base + path} -> HTTP {e.code}", file=sys.stderr)
        return 3 if e.code == 404 else 2
    except (urllib.error.URLError, OSError) as e:
        # kao: disable=KAO106 -- "error: ..." on stderr is the CLI's UX contract
        print(f"error: {base + path}: {e}", file=sys.stderr)
        return 2
    if args.trace_id and args.chrome:
        from .chrome import report_to_json

        _write(report_to_json(doc, indent=args.indent), args.output)
    else:
        _write(json.dumps(doc, indent=args.indent, default=str),
               args.output)
    return 0


def _cmd_flight(args) -> int:
    from .flight import follow_records, iter_records, snapshot_records

    if not Path(args.path).exists():
        # kao: disable=KAO106 -- "error: ..." on stderr is the CLI's UX contract
        print(f"error: no such file or directory: {args.path}",
              file=sys.stderr)
        return 3
    resume = None
    if args.follow and args.tail:
        # gap-free handoff: the snapshot returns a resume token (live
        # inode + byte offset + archive watermark) and the follow
        # continues at exactly that point, rotation-safe — a record
        # landing DURING the replay is delivered by the follow, never
        # skipped and never printed twice
        recs, resume = snapshot_records(args.path)
    elif not args.follow:
        recs = list(iter_records(args.path))
    else:
        recs = []
    if recs:
        recs = [r for r in recs
                if args.kind is None or r.get("kind") == args.kind]
        if args.tail:
            recs = recs[-args.tail:]
        for r in recs:
            # kao: disable=KAO106 -- the record stream on stdout IS the product
            print(json.dumps(r, separators=(",", ":"), default=str))
    if not args.follow:
        return 0
    printed = 0
    try:
        for r in follow_records(args.path, resume=resume):
            if args.kind is not None and r.get("kind") != args.kind:
                continue
            # kao: disable=KAO106 -- the record stream on stdout IS the product
            print(json.dumps(r, separators=(",", ":"), default=str),
                  flush=True)
            printed += 1
            if args.max is not None and printed >= args.max:
                break
    except KeyboardInterrupt:
        pass
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m kafka_assignment_optimizer_tpu_torch.obs.trace_cli",
        description="Dump/convert solve traces and flight records "
                    "(docs/OBSERVABILITY.md)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("convert",
                       help="solve report -> Chrome trace JSON")
    c.add_argument("report", help="solve-report JSON file")
    c.add_argument("-o", "--output", help="write here (default stdout)")
    c.add_argument("--indent", type=int, default=None)
    c.set_defaults(fn=_cmd_convert)

    f = sub.add_parser("fetch",
                       help="list/fetch solve reports from a server")
    f.add_argument("trace_id", nargs="?", default=None)
    f.add_argument("--url", required=True,
                   help="server base URL, e.g. http://127.0.0.1:8787")
    f.add_argument("--chrome", action="store_true",
                   help="convert the fetched report to Chrome trace JSON")
    f.add_argument("-o", "--output")
    f.add_argument("--indent", type=int, default=None)
    f.set_defaults(fn=_cmd_fetch)

    fl = sub.add_parser("flight", help="dump flight records")
    fl.add_argument("path", help="flight JSONL file or --flight-dir dir")
    fl.add_argument("--tail", type=int, default=None,
                    help="only the last N records")
    fl.add_argument("--kind", default=None,
                    help="filter by record kind (solve/delta/lane)")
    fl.add_argument("--follow", action="store_true",
                    help="tail -f the live file (rotation-safe: never "
                         "double-reads a record); combine with --tail "
                         "to replay history first")
    fl.add_argument("--max", type=int, default=None, metavar="N",
                    help="with --follow: exit after N followed records")
    fl.set_defaults(fn=_cmd_flight)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except (ValueError, OSError, json.JSONDecodeError) as e:
        # kao: disable=KAO106 -- "error: ..." on stderr is the CLI's UX contract
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
