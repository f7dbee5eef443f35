"""Drains of the port's accumulators (ops/runtime.py), one per row block
(bench.py `_per_query` .. `_ingest_snapshot`), plus what only the port has:
the kernel launches, the stage routes with their decline reasons, residency
and the chunked upload. Each drain resets its accumulator, so a row sees
only its own runs."""

from __future__ import annotations

from ballista_tpu_torch.ops import cuda_kernels, runtime


def _per_query(rb: dict | None, iters: int) -> dict | None:
    """A timed loop's totals as per-query numbers when every iteration did
    the same work; otherwise the raw totals, flagged per_query=false."""
    if rb is None:
        return rb
    if iters > 1 and any(v % iters for v in rb.values()):
        return {**rb, "per_query": False}
    return {**{k: v // max(iters, 1) for k, v in rb.items()}, "per_query": True}


def _readback_snapshot() -> dict | None:
    """Rows, bytes and transfers read back from the card since the last
    drain; None when no device readback ran."""
    s = runtime.readback_stats(reset=True)
    if not s.get("readbacks"):
        return None
    return {"readbacks": s["readbacks"], "readback_rows": s["rows"],
            "readback_bytes": s["bytes"]}


def _join_snapshot(iters: int = 1) -> dict | None:
    """Join paths (device / split / step_aside / host_fallback) with their
    reasons, normalized like _per_query; None when no join touched the
    device path."""
    s = runtime.join_path_stats(reset=True)
    if not s.get("paths"):
        return None
    prefix = "reasons\t"  # \t cannot occur in a path name
    flat = dict(s["paths"])
    for k, v in (s.get("reasons") or {}).items():
        flat[prefix + k] = v
    norm = _per_query(flat, iters)
    out = {k: v for k, v in norm.items() if not k.startswith(prefix) and k != "per_query"}
    reasons = {k[len(prefix):]: v for k, v in norm.items() if k.startswith(prefix)}
    if reasons:
        out["reasons"] = reasons
    out["per_query"] = norm["per_query"]
    return out


def _recovery_snapshot() -> dict | None:
    """Recovery event totals (retries, resets, lineage recomputes, chaos);
    None on a fault-free run."""
    s = {k: v for k, v in runtime.recovery_stats(reset=True).items() if v}
    return s or None


def _routing_snapshot() -> dict | None:
    """Routing totals since the last drain: the stage routes and their
    decline reasons, step-asides, the cost model's decisions (the port's
    routing events "<op>:<engine>", summed per engine as bench.py's
    `engines`), predicted against observed seconds, and the chunk size the
    last chunked upload picked. None when nothing was routed."""
    s = runtime.routing_stats(reset=True)
    if not (s["routes"] or s["events"] or s["reasons"] or s["step_asides"]):
        return None
    events, costs = s["events"], s["costs"]
    engines: dict = {}
    for ev, n in events.items():
        op, sep, engine = ev.rpartition(":")
        if sep and op:
            engines[engine] = engines.get(engine, 0) + n
    preds = costs.get("predictions", 0)
    return {
        "routes": s["routes"],
        "reasons": s["reasons"],
        "step_asides": s["step_asides"],
        "engines": engines,
        "predictions": preds,
        "mispredicts": costs.get("mispredicts", 0),
        "mispredict_rate": round(costs.get("mispredicts", 0) / preds, 4) if preds else 0.0,
        "predicted_s": round(costs.get("predicted_s", 0.0), 4),
        "observed_s": round(costs.get("observed_s", 0.0), 4),
        "splits": events.get("split", 0),
        "skew_replans": events.get("skew_replan", 0),
        "events": events,
        "h2d_chunk_bytes": s["h2d_chunk_bytes"],
    }


def _speculation_snapshot() -> dict | None:
    """Speculative-attempt totals and SLO outcomes; None when none."""
    s = {k: (round(v, 4) if k == "wasted_seconds" else int(v))
         for k, v in runtime.speculation_stats(reset=True).items() if v}
    return s or None


def _ingest_snapshot() -> dict | None:
    """Scan / encode / upload seconds of the stage prepares since the last
    drain; None when no prepare ran."""
    s = runtime.ingest_stats(reset=True)
    if not s.get("prepares"):
        return None
    return {"prepares": int(s["prepares"]),
            **{k: round(s[k], 3) for k in ("scan_s", "encode_s", "upload_s", "wall_s")}}


def _residency_snapshot() -> dict:
    """LRU residency decisions since the last drain and the bytes resident
    on the card now."""
    return {**runtime.residency_stats(reset=True), "resident_bytes": runtime.resident_bytes()}


def _launch_snapshot(before: dict) -> dict:
    """Kernel launches since `before` (a cuda_kernels.launch_counts())."""
    now = cuda_kernels.launch_counts()
    return {k: now[k] - before.get(k, 0) for k in now}


def drain_all() -> None:
    """Empty every accumulator a row reads, so the next row starts at 0."""
    for fn in (_ingest_snapshot, _readback_snapshot, _join_snapshot, _recovery_snapshot,
               _routing_snapshot, _speculation_snapshot, _residency_snapshot):
        fn()
