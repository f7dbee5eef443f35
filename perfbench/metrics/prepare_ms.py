"""Stage host prepare per query (layer: stage host prepare): the program's
`ingest_stats()["wall_s"]` over the window, per completed query."""

UNIT = "ms"


def read(run: dict):
    n = sum(r["ok"] for r in run["records"])
    return 1e3 * run["counters"]["ingest_wall_s"] / n if n else None
