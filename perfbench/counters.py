"""Snapshots of the program's own counters (ballista_tpu_torch.ops.runtime),
read before and after the window; the per-layer readers take the
difference. Reading never resets them."""

from __future__ import annotations


def engine_counters(serving: bool) -> dict:
    from ballista_tpu_torch.ops import runtime

    ingest = runtime.ingest_stats()
    readback = runtime.readback_stats()
    routes = runtime.routing_stats()["routes"]
    out = {
        "ingest_wall_s": ingest["wall_s"],
        "ingest_prepares": ingest["prepares"],
        "readback_bytes": readback["bytes"],
        "readbacks": readback["readbacks"],
        "routes_host": routes.get("host", 0),
        "routes_all": sum(routes.values()),
    }
    if serving:
        s = runtime.serving_stats()
        out["dispatch_push"] = s.get("dispatch_push", 0)
        out["dispatch_poll"] = s.get("dispatch_poll", 0)
    return out


def delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}
