"""The share of the window in which nothing ran on the card (layer:
device), from the same profile as device_ms."""

UNIT = "%"


def read(run: dict):
    t = run["trace"]
    if t is None or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
