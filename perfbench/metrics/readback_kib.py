"""Bytes read back from the card per query, in KiB (layer: readback):
`readback_stats()["bytes"]` over the window."""

UNIT = "KiB"


def read(run: dict):
    n = sum(r["ok"] for r in run["records"])
    return run["counters"]["readback_bytes"] / 1024 / n if n else None
