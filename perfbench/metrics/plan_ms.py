"""Planning per query (layer: planner): `ctx.sql` (parse and logical plan),
timed by the harness, plus the program's own `plan` span (optimize and
physical plan) that opens collect(). Local engine, one stream."""

UNIT = "ms"


def read(run: dict):
    xs = [r["plan_s"] for r in run["records"] if "plan_s" in r]
    return 1e3 * sum(xs) / len(xs) if xs else None
