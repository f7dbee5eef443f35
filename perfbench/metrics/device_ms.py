"""Device time per query (layer: device step): the union of every kernel,
copy and memset torch.profiler records on the card over the window, per
completed query."""

UNIT = "ms"


def read(run: dict):
    n = sum(r["ok"] for r in run["records"])
    t = run["trace"]
    if t is None or not n or t["busy_s"] <= 0:
        return None
    return 1e3 * t["busy_s"] / n
