"""Device kernel entry points used by operator dispatch.

hash_aggregate runs a HashAggregateExec's partial phase as one device
stage; resolve_stage builds or fetches that stage from a structural cache,
trying the JAX package's ladder in its order (_build_stage): the fact-side
pushdown (ops/factagg.py::FactAggregateStage), a mapped-scan rewrite whose
fused top-k is live when the fact stage cannot fuse its epilogue, the
mapped-scan rewrite (ops/mappedscan.py), and the fused stage over the
aggregate's own input (ops/stage.py::FusedAggregateStage). A rung that
steps aside counts its reason (step_aside) and the next rung is tried; only
the ladder's final verdict is a decline: the dispatcher records it
(runtime.record_route("host", reason)) and returns None, and the operator
runs its host Arrow path, which gives the same answer.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, Optional, Tuple

import pyarrow as pa

from ballista_tpu_torch.ops.runtime import UnsupportedOnDevice, record_route


def host_fallback(reason: str) -> None:
    """Canonical Optional-sentinel decline: logs and counts the reason, then
    returns the None the dispatcher maps to the host Arrow path."""
    from ballista_tpu_torch.utils import tracing

    tracing.incr("device.host_fallback")
    logging.getLogger("ballista.cuda").debug("host fallback: %s", reason)
    return None


def step_aside(reason: str) -> None:
    """Canonical mid-ladder decline: one rung steps aside and the next is
    tried, so the aggregate may still run on the device. Its reason is
    counted apart from host declines (runtime.routing_stats()
    ["step_asides"])."""
    from ballista_tpu_torch.ops.runtime import record_step_aside
    from ballista_tpu_torch.utils import tracing

    tracing.incr("device.step_aside")
    logging.getLogger("ballista.cuda").debug("ladder step-aside: %s", reason)
    record_step_aside(reason)
    return None


def _build_stage(exec_node):
    """The stage ladder (ballista_tpu/ops/kernels.py:324-361, in its
    order). Raises UnsupportedOnDevice with the final verdict."""
    from ballista_tpu_torch.ops.factagg import FactAggregateStage
    from ballista_tpu_torch.ops.mappedscan import try_rewrite_mapped
    from ballista_tpu_torch.ops.stage import FusedAggregateStage

    # aggregate over a join: the fact-side pushdown first
    built = FactAggregateStage.try_build(exec_node)
    if (
        built is not None
        and built.topk is None
        and getattr(exec_node, "_topk_pushdown", None) is not None
    ):
        # the fact stage admitted the shape but cannot fuse its epilogue
        # (dim-only grouping, q10: output groups are not fact keys). A
        # mapped rewrite groups by the OUTPUT keys, so the fused stage's
        # top-k applies: prefer it when its spec is live (O(limit) readback)
        rewritten = try_rewrite_mapped(exec_node)
        if rewritten is not None:
            try:
                alt = FusedAggregateStage(rewritten)
            except UnsupportedOnDevice as e:
                step_aside(f"mapped top-k rewrite: {e}")
            else:
                if alt.topk is not None:
                    built = alt
    if built is None:
        # shapes the fact stage excludes (multi-key fact joins, dim-valued
        # aggregate inputs, fact-column group keys: q7-q9, q12)
        rewritten = try_rewrite_mapped(exec_node)
        if rewritten is not None:
            built = FusedAggregateStage(rewritten)
    if built is None:
        built = FusedAggregateStage(exec_node)
    return built


# executor task threads run concurrently: lookup/insert are one atomic
# section, so two threads never each build (and pin) the same stage
_stage_cache_lock = threading.Lock()
_stage_cache: Dict[str, object] = {}  # guarded-by: _stage_cache_lock
# pins each cached stage's table source so its id() (part of the cache key
# for memory scans) can never be recycled by a different object
_stage_cache_pins: Dict[str, object] = {}  # guarded-by: _stage_cache_lock
# stable plan identity -> the latest full (mtime-bearing) cache key, so a
# rewritten file's superseded entry is dropped and its reservations freed
_stage_latest: Dict[str, str] = {}  # guarded-by: _stage_cache_lock


def clear_stage_cache() -> None:
    from ballista_tpu_torch.ops.runtime import release_stage_residency

    with _stage_cache_lock:
        for stage in _stage_cache.values():
            if stage not in (None, False):
                release_stage_residency(stage)
        _stage_cache.clear()
        _stage_cache_pins.clear()
        _stage_latest.clear()


def resolve_stage(exec_node, ctx) -> Tuple[object, str]:
    """Build-or-fetch the device stage for one aggregate node without
    running it. Returns (stage, key): `stage` is False when the shape
    permanently declined to the host path (cached verdict included)."""
    from ballista_tpu_torch.physical.scan import MemoryScanExec

    def leaves(node):
        if not node.children():
            yield node
        for c in node.children():
            yield from leaves(c)

    parts = []
    mtimes = []
    pinned = []
    for leaf in leaves(exec_node):
        if isinstance(leaf, MemoryScanExec):
            # memory scans carry no identity in their display
            parts.append(str(id(leaf.source)))
            pinned.append(leaf.source)
        elif hasattr(leaf, "source") and hasattr(leaf.source, "files"):
            # file mtimes invalidate the cached stage (and its resident
            # columns) when a file is rewritten
            parts.extend(leaf.source.files)
            for f in leaf.source.files:
                mtimes.append(str(os.path.getmtime(f)) if os.path.exists(f) else "0")
    # config flags and the device participate in the key: a decline under
    # one config must not pin the device path off for another, and a stage
    # holds tensors on exactly one device
    flags = (
        f"fv={ctx.config.tpu_fuse_volatile()},dc={ctx.config.device_cache()},"
        f"sk={ctx.config.tpu_sorted_kernel()},"
        f"topk={getattr(exec_node, '_topk_pushdown', None)},dev={ctx.device}"
    )
    if getattr(exec_node, "exact_floats", False):
        flags += ",ef=True"
    stable = exec_node.display_indent() + "|" + ",".join(parts) + "|" + flags
    key = stable + "|" + ",".join(mtimes)
    with _stage_cache_lock:
        stage = _stage_cache.get(key)
        if stage is None:
            old_key = _stage_latest.get(stable)
            if old_key is not None and old_key != key:
                old = _stage_cache.pop(old_key, None)
                _stage_cache_pins.pop(old_key, None)
                if old not in (None, False):
                    from ballista_tpu_torch.ops.runtime import release_stage_residency

                    release_stage_residency(old)
            _stage_latest[stable] = key
    if stage is None:
        # build OUTSIDE the lock; first insert wins on a racing build
        try:
            built = _build_stage(exec_node)
        except UnsupportedOnDevice as e:
            record_route("host", f"stage build: {e}")
            built = False
        with _stage_cache_lock:
            stage = _stage_cache.get(key)
            if stage is None:
                _stage_cache[key] = built
                _stage_cache_pins[key] = pinned
                stage = built
    return stage, key


def hash_aggregate(exec_node, partition: int, ctx) -> Optional[pa.Table]:
    stage, key = resolve_stage(exec_node, ctx)
    if stage is False:
        return None
    try:
        return stage.run(partition, ctx)
    except UnsupportedOnDevice as e:
        # permanently declined: free its resident columns and their budget
        # reservations before dropping the stage, and say why
        reason = f"stage permanently declined: {e}"
        logging.getLogger("ballista.cuda").warning(
            "device stage permanently declined to host: %s", e
        )
        from ballista_tpu_torch.ops.runtime import release_stage_residency

        release_stage_residency(stage)
        with _stage_cache_lock:
            _stage_cache[key] = False
        record_route("host", str(e))
        return host_fallback(reason)
