"""``kao-check`` CLI over the port:
``python -m kafka_assignment_optimizer_tpu_torch.analysis``.

The reference's flags, exit codes (0 clean, 1 findings, 2 usage/internal
error), formats and ratchet. The lint pass is pure stdlib and imports no
torch; the runtime contracts pass (on by default, ``--no-contracts`` to
skip) runs the real steppers on ``--device``: the card by default, like
every entry point of the package. Without a card and without
``--device cpu`` it fails (exit 2); it never falls back to the CPU.

    python -m kafka_assignment_optimizer_tpu_torch.analysis --device cpu \
        --baseline analysis_baseline_torch.json
"""

from __future__ import annotations

import argparse
import json
import sys

from . import RULES, lint_paths, package_root


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="kao-check",
        description="Project-native static analysis of the PyTorch port "
        "(rule catalog: the README's port section).",
    )
    ap.add_argument(
        "paths", nargs="*",
        help="files/directories to lint (default: the package tree)",
    )
    ap.add_argument(
        "--rule", action="append", metavar="KAO1xx",
        help="restrict the lint pass to these rule IDs (repeatable)",
    )
    ap.add_argument(
        "--no-contracts", action="store_true",
        help="skip the runtime contract pass (lint only; no torch "
        "import)",
    )
    ap.add_argument(
        "--contracts-only", action="store_true",
        help="run only the runtime contract pass",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="device of the runtime contract pass (default: cuda, the "
        "card; 'cpu' runs the steppers' plain versions on the CPU)",
    )
    ap.add_argument(
        "--format", choices=["text", "json", "sarif"], default="text",
    )
    ap.add_argument(
        "--baseline", metavar="FILE",
        help="findings-ratchet baseline (analysis_baseline_torch.json): "
        "baselined findings are tolerated, NEW findings fail, and "
        "fixed-but-not-removed baseline entries also fail",
    )
    ap.add_argument(
        "--update-baseline", action="store_true",
        help="rewrite --baseline FILE from the current findings "
        "(the only sanctioned way to shrink or refresh it)",
    )
    ap.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit",
    )
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.contracts_only and args.no_contracts:
        # both flags together would run zero checks and exit 0 — a
        # silent green no-op gate
        build_parser().error(
            "--contracts-only and --no-contracts are mutually exclusive"
        )
    if args.contracts_only and args.paths:
        # the contract pass runs the installed package's real
        # steppers; explicit paths scope the LINT pass only — accepting
        # both would run zero checks and report a green no-op
        build_parser().error(
            "--contracts-only does not take paths (contracts always "
            "run against the installed package)"
        )
    if args.update_baseline and not args.baseline:
        build_parser().error("--update-baseline requires --baseline")
    if args.rule:
        unknown = sorted(set(args.rule) - set(RULES))
        if unknown:
            # an unknown ID would filter every finding out and turn a
            # typo into a permanently green gate
            build_parser().error(
                f"unknown rule id(s): {', '.join(unknown)} "
                "(see --list-rules)"
            )
    if args.list_rules:
        for rid, title in sorted(RULES.items()):
            # kao: disable=KAO106 -- kao-check's own stdout IS the product
            print(f"{rid}  {title}")
        return 0
    run_contracts = not args.no_contracts and (
        args.contracts_only or not args.paths)
    if run_contracts:
        from .contracts import resolve_device

        try:
            resolve_device(args.device)
        except RuntimeError as exc:
            # no card: a usage error, never a silent fall back to the CPU
            build_parser().error(f"--device {args.device}: {exc}")
    findings = []
    if not args.contracts_only:
        findings += lint_paths(args.paths or None,
                               rules=set(args.rule) if args.rule else None)
    if run_contracts:
        # contracts run the real steppers — meaningful only for the
        # package itself, so explicit fixture paths skip them
        from .contracts import run_contracts as _run

        findings += _run(device=args.device).findings

    from . import baseline as _baseline

    if args.update_baseline:
        _baseline.save(args.baseline, findings)
        # kao: disable=KAO106 -- kao-check's own stdout IS the product
        print(f"kao-check: baseline rewritten with {len(findings)} "
              f"finding(s): {args.baseline}")
        return 0

    ratchet = None
    if args.baseline:
        try:
            entries = _baseline.load(args.baseline)
        except (OSError, ValueError, json.JSONDecodeError) as exc:
            build_parser().error(f"--baseline: {exc}")
        ratchet = _baseline.compare(findings, entries)

    if args.format == "json":
        # kao: disable=KAO106 -- kao-check's own stdout IS the product
        print(json.dumps(
            [f.__dict__ for f in findings], indent=2
        ))
    elif args.format == "sarif":
        from . import sarif as _sarif

        known = (set() if ratchet is None else
                 {i for i, f in enumerate(findings)
                  if f in ratchet.known})
        # kao: disable=KAO106 -- kao-check's own stdout IS the product
        print(json.dumps(_sarif.render(findings, known), indent=2))
    else:
        fail_set = findings if ratchet is None else ratchet.new
        for f in fail_set:
            # kao: disable=KAO106 -- kao-check's own stdout IS the product
            print(f.render())
        if ratchet is not None:
            for e in ratchet.stale:
                # kao: disable=KAO106 -- kao-check's own stdout IS the product
                print(f"{e['path']}: stale baseline entry for "
                      f"{e['rule']} ({e['message']!r}) — the finding "
                      "is fixed; run --update-baseline to drop it")
        root = args.paths or [package_root()]
        tail = ("" if ratchet is None else
                f" ({len(ratchet.known)} baselined, "
                f"{len(ratchet.stale)} stale)")
        # kao: disable=KAO106 -- kao-check's own stdout IS the product
        print(
            f"kao-check: {len(fail_set)} "
            f"finding(s) in {', '.join(root)}{tail}"
        )
    if ratchet is not None:
        return 0 if ratchet.clean else 1
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
