"""``python -m nomad_tpu_torch.lint`` — run all passes, apply the baseline,
exit 0 only when every finding is allowlisted.

Output contract (the reference's, ``nomad_tpu/lint/__main__.py``):

* new findings print one-per-line as ``path:line: RULE [symbol] msg``;
* stale baseline entries (matched nothing this run) are reported so the
  allowlist ratchets down — stale entries alone do not fail the run;
* ``--verbose`` also prints what the baseline suppressed.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from . import load_baseline, repo_root, run_all, split_baselined


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="nomad lint",
        description="lock-discipline + dispatch hot-path + chaos-seam + "
        "observability static analysis",
    )
    ap.add_argument("--root", default=None, help="repo root (default: auto-detect)")
    ap.add_argument(
        "--baseline", default=None, help="baseline.json path (default: committed)"
    )
    ap.add_argument(
        "-v", "--verbose", action="store_true",
        help="also list findings the baseline suppressed",
    )
    args = ap.parse_args(argv)

    root = args.root or repo_root()
    findings = run_all(root)
    baseline = load_baseline(args.baseline)
    new, suppressed, stale = split_baselined(findings, baseline)

    for f in new:
        print(f.render())
    if args.verbose and suppressed:
        print(f"-- baseline suppressed {len(suppressed)} finding(s):")
        for f in suppressed:
            print(f"   {f.render()}")
    for e in stale:
        print(
            "-- stale baseline entry (matched nothing — delete it): "
            f"{e.get('rule')} {e.get('path')} [{e.get('symbol')}]"
        )

    if new:
        print(
            f"nomad lint: {len(new)} new finding(s) "
            f"({len(suppressed)} baselined, {len(stale)} stale entries)"
        )
        return 1
    print(
        f"nomad lint: clean ({len(suppressed)} baselined, "
        f"{len(stale)} stale entries)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
