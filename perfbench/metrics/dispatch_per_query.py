"""Task dispatches per query (layer: scheduler): `serving_stats()`
`dispatch_push` + `dispatch_poll` over the window. Engines with a
scheduler only."""

UNIT = "count"


def read(run: dict):
    c = run["counters"]
    n = sum(r["ok"] for r in run["records"])
    if "dispatch_push" not in c or not n:
        return None
    return (c["dispatch_push"] + c["dispatch_poll"]) / n
