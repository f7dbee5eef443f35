"""CLI: python -m ballista_tpu_torch.analysis [paths...] [--json] [--no-cache]
[--cache-file PATH] [--check-witness DUMP ...]

The default scope is the ballista_tpu_torch package (without this
subpackage).

Exit codes: 0 clean, 1 findings, 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ballista_tpu_torch.analysis.core import run_paths

# the package this analyzer belongs to (its own subpackage is skipped)
PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SUPPRESSION_BUDGET = 5  # package-wide cap, the JAX package's


def check_witness(witness_paths, paths, as_json: bool = False,
                  use_cache: bool = True, cache_path=None) -> int:
    """--check-witness: runtime-vs-static lock-order cross-check.

    Accepts the flag repeatedly: a witness run spanning several processes
    (the daemons, a forked worker) leaves one <OUT>.<pid> record each, and
    the edge sets are MERGED (union of edges with summed counts, violations
    concatenated) before the diff — an edge witnessed in any process
    counts, a declared edge is stale only if NO process saw it.

    Exit 1 when the merged witness recorded edges the static analyzer
    never derived (analyzer bugs / missing may-acquire annotations) or
    recorded order violations; stale declared edges only warn."""
    from ballista_tpu_torch.analysis.lockgraph import Manifest, diff_witness, load_witness
    from ballista_tpu_torch.analysis.rules_lockorder import static_edges

    witness = {"edges": [], "violations": []}
    seen = {}
    for wp in witness_paths:
        try:
            rec = load_witness(wp)
        except (OSError, ValueError) as e:
            print(f"error: cannot read witness {wp}: {e}", file=sys.stderr)
            return 2
        for edge in rec.get("edges", ()):
            key = (edge.get("src"), edge.get("dst"))
            if key in seen:
                seen[key]["count"] = seen[key].get("count", 1) \
                    + edge.get("count", 1)
            else:
                seen[key] = dict(edge)
                witness["edges"].append(seen[key])
        witness["violations"].extend(rec.get("violations", ()))
    edges = static_edges(paths, use_cache=use_cache, cache_path=cache_path)
    report = diff_witness(witness, edges, Manifest.load())
    report["static_edges"] = len(edges)
    report["witness_files"] = len(witness_paths)
    report["ok"] = not report["missed"] and not report["violations"]
    if as_json:
        print(json.dumps(report, indent=2))
    else:
        print(f"witness: {report['runtime_edges']} runtime edge(s) from "
              f"{report['witness_files']} dump(s), "
              f"{report['static_edges']} static edge(s)")
        for s, d in report["missed"]:
            print(f"MISSED statically: {s} -> {d} (analyzer bug or missing "
                  "`# may-acquire:` on a dynamic-dispatch seam)")
        for v in report["violations"]:
            print(f"RUNTIME VIOLATION: {v.get('kind')} "
                  f"{v.get('src', v.get('lock'))} -> {v.get('dst', '')}")
        for s, d in report["never_witnessed"]:
            print(f"stale (declared, never witnessed): {s} -> {d}")
    return 0 if report["ok"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ballista_tpu_torch.analysis",
        description="ballista-lint: AST-based invariant checker "
                    "(readback, tracer, dtype, lock, decline discipline)",
    )
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories (default: the "
                         "ballista_tpu_torch package)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--no-cache", action="store_true",
                    help="ignore and do not write the per-file result cache")
    ap.add_argument("--cache-file", default=None,
                    help="cache location (default: "
                         "<repo>/.ballista_torch_lint_cache.json)")
    ap.add_argument("--check-witness", metavar="WITNESS_JSON", default=None,
                    action="append",
                    help="diff a runtime lock-witness dump "
                         "(utils/locks.py, ballista.debug.lock_witness) against the static "
                         "lock-order graph: runtime edges the analyzer "
                         "missed fail; declared-but-never-witnessed edges "
                         "are flagged stale. Repeatable: multi-process "
                         "lanes dump one <OUT>.<pid> file each, and the "
                         "edge sets merge before the diff")
    args = ap.parse_args(argv)

    paths = args.paths or [PACKAGE_DIR]

    if args.check_witness:
        return check_witness(args.check_witness, paths, as_json=args.as_json,
                             use_cache=not args.no_cache,
                             cache_path=args.cache_file)

    try:
        findings, stats = run_paths(
            paths, use_cache=not args.no_cache, cache_path=args.cache_file,
        )
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    over_budget = stats["suppressions"] > SUPPRESSION_BUDGET
    if args.as_json:
        print(json.dumps({
            "findings": [f.to_dict() for f in findings],
            "stats": stats,
            "suppression_budget": SUPPRESSION_BUDGET,
            "over_suppression_budget": over_budget,
            "ok": not findings and not over_budget,
        }, indent=2))
    else:
        for f in findings:
            print(f.format())
        print(
            f"ballista-lint: {stats['files']} files "
            f"({stats['cache_hits']} cached), {len(findings)} finding(s), "
            f"{stats['suppressions']} suppression(s)"
        )
        # per-rule cost/yield: only rules that found
        # something are worth a line; clean runs keep the one-line summary
        for rule, rec in stats.get("rules", {}).items():
            if rec["findings"]:
                print(f"  {rule}: {rec['findings']} finding(s), "
                      f"{rec['wall_s']:.3f}s")
        if over_budget:
            print(
                f"ballista-lint: suppression budget exceeded "
                f"({stats['suppressions']} > {SUPPRESSION_BUDGET})",
                file=sys.stderr,
            )
    return 1 if findings or over_budget else 0


if __name__ == "__main__":
    sys.exit(main())
