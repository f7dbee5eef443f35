"""Stage runs the stage ladder sent to the host, per query (layer: stage
ladder): `routing_stats()["routes"]["host"]` over the window."""

UNIT = "count"


def read(run: dict):
    n = sum(r["ok"] for r in run["records"])
    return run["counters"]["routes_host"] / n if n else None
