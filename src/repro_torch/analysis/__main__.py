"""CLI: ``python -m repro_torch.analysis [--modes plain,meta] [--strict]
[--json PATH] ...``.

The modes default to ``cuda`` (the card); on a machine without one ask for
``--modes plain,meta``.  Exit code 0 == clean (under ``--strict`` *any*
finding fails; otherwise only ``severity == "error"`` findings do)."""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static kernel-contract and config-rot checker of the port: ATen-op "
                    "lints, cache-buffer checks, bounds proofs of the CUDA kernels' "
                    "address arithmetic, mesh, paging and resilience checks over every "
                    "shipped config.")
    ap.add_argument("--configs", default=None,
                    help="comma-separated config names (default: all)")
    ap.add_argument("--modes", default=None,
                    help="comma-separated modes of plain, meta, cuda (default: cuda)")
    ap.add_argument("--quants", default=None,
                    help="comma-separated quant modes (default: none,w8a8)")
    ap.add_argument("--disable", action="append", default=[], metavar="RULE",
                    help="disable a rule id (repeatable)")
    ap.add_argument("--strict", action="store_true",
                    help="fail on any finding, warnings included")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the full report as JSON")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="suppress per-cell progress lines")
    args = ap.parse_args(argv)

    # import after arg parsing so ``--list-rules``/``--help`` stay instant
    from repro_torch.analysis.findings import RULES
    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule}  {desc}")
        return 0
    for rule in args.disable:
        if rule not in RULES:
            ap.error(f"unknown rule {rule!r}; see --list-rules")

    from repro_torch.analysis.runner import run_analysis
    progress = None if args.quiet else (
        lambda msg: print(f"[analysis] {msg}", file=sys.stderr, flush=True))
    report = run_analysis(
        configs=args.configs.split(",") if args.configs else None,
        modes=args.modes.split(",") if args.modes else ("cuda",),
        quants=args.quants.split(",") if args.quants else ("none", "w8a8"),
        disabled=args.disable,
        progress=progress)

    for f in report.findings:
        print(f)
    if args.json:
        report.dump(args.json)
    n = len(report.findings)
    print(f"[analysis] {len(report.checked)} surfaces checked, "
          f"{n} finding{'s' if n != 1 else ''}"
          + (f", disabled: {','.join(report.disabled)}"
             if report.disabled else ""))
    return report.exit_code(strict=args.strict)


if __name__ == "__main__":
    sys.exit(main())
