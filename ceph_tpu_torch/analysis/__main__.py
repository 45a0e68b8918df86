"""``python -m ceph_tpu_torch.analysis`` — the invariant analyzer runner.

Exit status 0 = clean, 1 = violations, 2 = usage error.  The tier-1
suite runs the full-tree pass (tests/test_torch_analysis.py);
``--changed`` scopes to the git working-tree diff for fast pre-commit
rounds.
"""
from __future__ import annotations

import argparse
import json
import sys

from .core import PKG_ROOT, changed_files, run_analysis
from .rules import ALL_RULES, rule_by_id


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ceph_tpu_torch.analysis",
        description="repo-wide AST invariant analyzer")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to analyze (default: ceph_tpu_torch/)")
    ap.add_argument("--rule", action="append", dest="rules",
                    metavar="RULE-ID",
                    help="run only this rule (repeatable)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable violation list on stdout")
    ap.add_argument("--changed", action="store_true",
                    help="git-diff-scoped: only working-tree-changed "
                         "ceph_tpu_torch/*.py files")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--update-wire-manifest", action="store_true",
                    help="regenerate analysis/wire_manifest.json from "
                         "msg/messages.py (requires corpus "
                         "re-validation — see docs/ANALYSIS.md)")
    args = ap.parse_args(argv)

    if args.list_rules:
        for cls in ALL_RULES:
            print(f"{cls.id:24s} {cls.doc}")
        return 0

    if args.update_wire_manifest:
        import os

        from .core import AnalysisContext
        from .rules import WIRE_MANIFEST_PATH, collect_wire_fields
        ctx = AnalysisContext(os.path.join(PKG_ROOT, "msg",
                                           "messages.py"))
        fields = collect_wire_fields(ctx.tree)
        with open(WIRE_MANIFEST_PATH, "w", encoding="utf-8") as f:
            json.dump(fields, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wire manifest: {len(fields)} message classes -> "
              f"{WIRE_MANIFEST_PATH}")
        return 0

    rules = None
    if args.rules:
        try:
            rules = [rule_by_id(r) for r in args.rules]
        except KeyError as e:
            print(e.args[0], file=sys.stderr)
            return 2

    paths = args.paths or None
    if args.changed:
        paths = changed_files()
        if not paths:
            print("analysis: no changed ceph_tpu_torch/*.py files")
            return 0

    violations = run_analysis(paths, rules)
    if args.json:
        print(json.dumps([v.__dict__ for v in violations], indent=1))
    else:
        for v in violations:
            print(v)
        n_rules = len(rules) if rules else len(ALL_RULES)
        print(f"analysis: {len(violations)} violation(s), "
              f"{n_rules} rule(s)", file=sys.stderr)
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
