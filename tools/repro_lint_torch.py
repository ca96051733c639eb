#!/usr/bin/env python
"""Invariant lint of the PyTorch port: run its static checkers on its tree.

Usage (from the repo root; src/ must be importable, e.g. PYTHONPATH=src):

    python tools/repro_lint_torch.py --all                 # all checkers + protocol sweep
    python tools/repro_lint_torch.py --checker host        # one source checker
    python tools/repro_lint_torch.py --protocol            # halo-protocol topology sweep
    python tools/repro_lint_torch.py --all --update-baseline

The twin of ``tools/repro_lint.py`` over ``src/repro_torch``, with the
scopes of ``repro_torch.analysis.config.DEFAULTS`` and the baseline
``tools/repro_lint_torch_baseline.json``. Exit status is 0 iff there are
no non-baselined findings and no stale baseline entries. ``--checker
donation`` is accepted and only says why the port has no such check.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT / "src"))

from repro_torch.analysis import (  # noqa: E402
    CHECKERS,
    apply_baseline,
    load_baseline,
    load_config,
    render,
    run,
    sweep_topologies,
    write_baseline,
)

NO_DONATION = (
    "repro_lint_torch: donation: no check — the port donates no buffer "
    "(pull stencils ping-pong between two buffers and every program returns "
    "fresh tensors)"
)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--all", action="store_true", help="run every checker plus the protocol sweep")
    ap.add_argument(
        "--checker", action="append", choices=sorted([*CHECKERS, "donation"]), default=[],
        help="run one source checker (repeatable)",
    )
    ap.add_argument("--protocol", action="store_true", help="run the halo-protocol topology sweep")
    ap.add_argument(
        "--ranks", default=None,
        help="comma-separated rank counts for the protocol sweep (default from the port's config)",
    )
    ap.add_argument(
        "--update-baseline", action="store_true",
        help="rewrite the baseline to the current findings (audit the diff!)",
    )
    ap.add_argument("--no-baseline", action="store_true", help="report raw findings, ignore the baseline")
    ap.add_argument("--root", default=str(REPO_ROOT), help="repo root to lint")
    args = ap.parse_args(argv)

    root = Path(args.root).resolve()
    cfg = load_config(root)

    if "donation" in args.checker:
        print(NO_DONATION)
    names = list(CHECKERS) if args.all else [n for n in args.checker if n != "donation"]
    if not names and not args.protocol and not args.all:
        if args.checker:  # --checker donation alone
            return 0
        ap.error("pick --all, --checker NAME, or --protocol")

    findings = run(cfg, names) if names else []
    if args.all or args.protocol:
        ranks = args.ranks or ",".join(str(r) for r in cfg.section("protocol")["ranks"])
        findings += sweep_topologies(tuple(int(r) for r in ranks.split(",")))

    if args.update_baseline:
        write_baseline(cfg.baseline_path, findings)
        print(f"baseline written: {cfg.baseline_path} ({len(findings)} entries)")
        return 0

    baseline = [] if args.no_baseline else load_baseline(cfg.baseline_path)
    new, suppressed, stale = apply_baseline(findings, baseline, root)

    for f in new:
        print(render(f))
    for msg in stale:
        print(f"baseline: {msg}")
    checker_names = sorted(set(names) | ({"protocol"} if (args.all or args.protocol) else set()))
    print(
        f"repro_lint_torch: {len(new)} finding(s), {len(suppressed)} baselined, "
        f"{len(stale)} stale baseline entr{'y' if len(stale) == 1 else 'ies'} "
        f"[checkers: {', '.join(checker_names)}]"
    )
    return 1 if new or stale else 0


if __name__ == "__main__":
    sys.exit(main())
