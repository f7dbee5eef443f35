"""Device kernel entry points used by operator dispatch.

hash_aggregate runs a HashAggregateExec's partial phase as one device
stage, after the COUNT-over-LEFT-join prescreen (ops/countjoin.py);
resolve_stage builds or fetches that stage from a structural cache,
trying the JAX package's ladder in its order (_build_stage): the fact-side
pushdown (ops/factagg.py::FactAggregateStage), a mapped-scan rewrite whose
fused top-k is live when the fact stage cannot fuse its epilogue, the
mapped-scan rewrite (ops/mappedscan.py), and the fused stage over the
aggregate's own input (ops/stage.py::FusedAggregateStage). A rung that
steps aside counts its reason (step_aside) and the next rung is tried; only
the ladder's final verdict is a decline: the dispatcher records it
(runtime.record_route("host", reason)) and returns None, and the operator
runs its host Arrow path, which gives the same answer.

The cache key (stage_identity) is the plan display, the leaf files and
their mtimes, the config flags, the device and a non-default batch size.
A fully file-backed stage also gets it as its persist_key (the persisted
layout cache, ops/layout_cache.py) and a chunk-set delta base. Each stage
run is a cost observation, "stage.run|<sha1 of the stable key>", and a
"stage:device" routing decision.

It also holds the device join's admission tiers (the static multiplicity
ladder and the cost model's extended tiers) and filter_batch, the
per-batch device filter of a FilterExec outside any fused stage.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np
import pyarrow as pa

from ballista_tpu_torch.ops.runtime import (
    ScanDictionaries,
    UnsupportedOnDevice,
    bucket_rows,
    column_to_numpy,
    pad_to,
    readback,
    record_route,
    record_routing,
    upload,
)
from ballista_tpu_torch.utils import tracing
from ballista_tpu_torch.utils.locks import make_lock


def host_fallback(reason: str) -> None:
    """Canonical Optional-sentinel decline: logs and counts the reason, then
    returns the None the dispatcher maps to the host Arrow path. Inside a
    routing probe the trace buffers with the decision counters, so a
    speculative attempt that declined leaves no phantom fallback."""
    from ballista_tpu_torch.ops.runtime import record_decline_trace

    record_decline_trace("device.host_fallback", f"host fallback: {reason}")
    return None


def step_aside(reason: str) -> None:
    """Canonical mid-ladder decline: one rung steps aside and the next is
    tried, so the aggregate may still run on the device. Its reason is
    counted apart from host declines (runtime.routing_stats()
    ["step_asides"])."""
    from ballista_tpu_torch.ops.runtime import record_step_aside

    tracing.incr("device.step_aside")
    logging.getLogger("ballista.cuda").debug("ladder step-aside: %s", reason)
    record_step_aside(reason)
    return None


# -- M:N join admission ------------------------------------------------------
# Bounded-width gather tiers for the device hash join (ops/join.py): duplicate
# build keys expand each probe into up to max-multiplicity matched rows, and
# the gather width is the smallest tier covering the observed maximum
# run-length. Shapes past the top tier, or whose padded [probe slots x width]
# plane would exceed the element cap, step aside to the host sort-merge join
# with a recorded reason. The tiers, caps and probe-slot padding are the JAX
# package's, so both packages take the same decision on the same input.
JOIN_MULTIPLICITY_TIERS = (1, 4, 16, 64, 256)
# padded gather elements (probe slots x width); past this the bounded-width
# plane and its readback cost more than the host join it replaces (2^26
# int32 elements = 256 MiB on the wire)
JOIN_GATHER_CAP = 1 << 26


def join_multiplicity_tier(
    max_mult: int, probe_slots: int
) -> Tuple[Optional[int], Optional[str]]:
    """Admission for the M:N bounded-width gather: (tier, None) with the
    smallest width covering `max_mult`, or (None, reason) past the ladder."""
    for tier in JOIN_MULTIPLICITY_TIERS:
        if max_mult <= tier:
            # width 1 reads back exactly one int32 per probe, uncapped: the
            # cap guards the padding amplification, which exists only past
            # width 1
            if tier > 1 and probe_slots * tier > JOIN_GATHER_CAP:
                return None, (
                    f"M:N gather {probe_slots}x{tier} exceeds the "
                    f"{JOIN_GATHER_CAP}-element cap"
                )
            return tier, None
    return None, (
        f"build-key multiplicity {max_mult} exceeds top tier "
        f"{JOIN_MULTIPLICITY_TIERS[-1]}"
    )


# -- cost-model tier extension ------------------------------------------------
# The static ladder above stays the cold-start prior AND the hard safety cap:
# a shape it declines may still run on the device, but only when the
# measured cost store (ops/costmodel.py) says the device gather beats the
# host join for that shape, and never past the hard cap below.
JOIN_EXTENDED_TIERS = (512, 1024)
JOIN_GATHER_HARD_CAP = JOIN_GATHER_CAP * 4
# predicted device cost must beat the host prediction by this margin
_EXT_MARGIN = 0.75


def join_extended_tier(
    max_mult: int, probe_slots: int, host_units: int
) -> Optional[Tuple[int, float, float]]:
    """Evidence-gated admission past the static ladder: (tier, predicted
    device seconds, predicted host seconds) when the warm store says the
    gather beats the host join by _EXT_MARGIN; None when cold, unfavourable
    or past the hard cap. The static widths are candidates too: a join
    declined only on the element cap re-admits at its natural width.
    `host_units` is the host join's work measure (build + probe rows)."""
    from ballista_tpu_torch.ops import costmodel

    for tier in JOIN_MULTIPLICITY_TIERS + JOIN_EXTENDED_TIERS:
        if max_mult <= tier:
            if probe_slots * tier > JOIN_GATHER_HARD_CAP:
                return None
            dev = costmodel.predict("join.gather", probe_slots * tier)
            host = costmodel.predict("join.host", host_units, engine="host")
            if dev is None or host is None:
                return None  # cold store: the static ladder is the prior
            if dev < _EXT_MARGIN * host:
                return tier, dev, host
            return None
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
                # the fact stage built above takes the query and records its
                # route when it runs; step_aside counts this reason apart
                # cold-path: the decision is the fact stage's route
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
_stage_cache_lock = make_lock("ops.kernels._stage_cache_lock")
_stage_cache: Dict[str, object] = {}  # guarded-by: _stage_cache_lock
# pins each cached stage's table source so its id() (part of the cache key
# for memory scans) can never be recycled by a different object
_stage_cache_pins: Dict[str, object] = {}  # guarded-by: _stage_cache_lock
# stable plan identity -> the latest full (mtime-bearing) cache key, so a
# rewritten file's superseded entry is dropped and its reservations freed
_stage_latest: Dict[str, str] = {}  # guarded-by: _stage_cache_lock


def clear_stage_cache() -> None:
    """Drop every cached stage, its pins and the shared layouts they bind."""
    from ballista_tpu_torch.ops.runtime import release_stage_residency
    from ballista_tpu_torch.ops.stage import clear_layouts

    with _stage_cache_lock:
        for stage in _stage_cache.values():
            if stage not in (None, False):
                release_stage_residency(stage)
        _stage_cache.clear()
        _stage_cache_pins.clear()
        _stage_latest.clear()
    clear_layouts()


def stage_identity(exec_node, ctx) -> dict:
    """The stage cache's identity of one aggregate node: {"key" (plan
    display + leaf files + config flags + mtimes), "stable" (the key
    without the mtimes), "chunk_base" (plan display + flags: the chunk-set
    delta base), "unit_size" (leaf file bytes, or memory-scan rows: the
    units of the stage.run cost observation), "file_backed" (every leaf is
    a file set whose mtimes cover it), "pinned" (memory-scan sources the
    key names by id())}."""
    from ballista_tpu_torch.config import BALLISTA_BATCH_SIZE, DEFAULT_SETTINGS
    from ballista_tpu_torch.physical.scan import MemoryScanExec

    def leaves(node):
        if not node.children():
            yield node
        for c in node.children():
            yield from leaves(c)

    parts = []
    mtimes = []
    pinned = []
    unit_size = 0.0
    # persisted-layout eligibility: every leaf's data identity must be a
    # file set with covering mtimes; any other leaf would leave the key
    # constant across data changes, and a disk hit could serve stale tiles
    file_backed = True
    for leaf in leaves(exec_node):
        if isinstance(leaf, MemoryScanExec):
            # memory scans carry no identity in their display
            parts.append(str(id(leaf.source)))
            pinned.append(leaf.source)
            unit_size += float(sum(
                b.num_rows for part in getattr(leaf.source, "partitions", ())
                for b in part
            ))
        elif hasattr(leaf, "source") and hasattr(leaf.source, "files"):
            # file mtimes invalidate the cached stage (and its resident
            # columns) when a file is rewritten
            parts.extend(leaf.source.files)
            for f in leaf.source.files:
                if os.path.exists(f):
                    mtimes.append(str(os.path.getmtime(f)))
                    try:
                        unit_size += float(os.path.getsize(f))
                    except OSError:
                        pass
                else:
                    mtimes.append("0")
                    file_backed = False
        else:
            file_backed = False
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
    # the batch size, appended only when it is not the default: a persisted
    # layout's tile granularity follows it, so two batch sizes are two keys
    # (and two sets of store entries)
    if ctx.batch_size != int(DEFAULT_SETTINGS[BALLISTA_BATCH_SIZE]):
        flags += f",bs={ctx.batch_size}"
    display = exec_node.display_indent()
    stable = display + "|" + ",".join(parts) + "|" + flags
    # the chunk-set delta base leaves out the row-transparent MergeExec
    # that a second file adds to the plan: a chunk's host arrays depend on
    # its file and the fused chain's expressions, not on how many files
    # the directory holds, so a directory that grows from one file to two
    # reuses the first file's chunks (the JAX package's base keeps the
    # MergeExec line and re-prepares them; ROADMAP differences by design)
    chain = " / ".join(line.strip() for line in display.splitlines()
                       if line.strip() != "MergeExec")
    return {"key": stable + "|" + ",".join(mtimes), "stable": stable,
            "chunk_base": chain + "|" + flags, "unit_size": unit_size,
            "file_backed": file_backed, "pinned": pinned}


def resolve_stage(exec_node, ctx) -> Tuple[object, str, str, float]:
    """Build-or-fetch the device stage for one aggregate node without
    running it. Returns (stage, key, stable, unit_size) of stage_identity:
    `stage` is False when the shape permanently declined to the host path
    (cached verdict included)."""
    ident = stage_identity(exec_node, ctx)
    key, stable, pinned = ident["key"], ident["stable"], ident["pinned"]
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
        # persisted layouts only for fully file-backed stages: memory-scan
        # keys embed id(), which another process could reuse for other
        # data, and a leaf without mtimes leaves the key constant
        if built is not False and not pinned and ident["file_backed"]:
            # the chunk-set delta base: the plan display names the scan
            # directory, not the file list, so it stays the same across
            # appends. A fact stage's inner stage prepares, so it gets both
            for st in (built, getattr(built, "inner", None)):
                if st is not None:
                    st.persist_key = key
                    st.chunk_key_base = ident["chunk_base"]
        with _stage_cache_lock:
            stage = _stage_cache.get(key)
            if stage is None:
                _stage_cache[key] = built
                _stage_cache_pins[key] = pinned
                stage = built
    return stage, key, stable, ident["unit_size"]


def hash_aggregate(exec_node, partition: int, ctx) -> Optional[pa.Table]:
    import hashlib

    from ballista_tpu_torch.ops import costmodel

    # bind the cost model from this dispatch's config before any path that
    # observes (the count-join prescreen included)
    costmodel.configure(ctx.config)
    # shared-scan splice: the batched task's executor already ran this
    # node's partition over one shared upload (ops/sharedscan.py), giving
    # exactly what stage.run below would. Checked before the count-join
    # prescreen: only scan-rooted stages are precomputed, and the count
    # join only matches join shapes, so the two never claim one node
    shared = getattr(ctx, "shared_scan", None)
    if shared is not None:
        hit = shared.take(exec_node, partition)
        if hit is not None:
            record_routing("batch", "stage")
            return hit
    # COUNT over a LEFT join as device membership counting (q13): the
    # per-probe counts plane replaces the join expansion. A cheap shape
    # prescreen: other aggregates fall through to the stage ladder
    if ctx.config.tpu_device_join():
        from ballista_tpu_torch.ops.countjoin import try_count_left_join

        counted = try_count_left_join(exec_node, partition, ctx)
        if counted is not None:
            return counted
    with tracing.span("stage.resolve"):
        stage, key, stable, unit_size = resolve_stage(exec_node, ctx)
    if stage is False:
        return None
    try:
        # the run is a cost-store observation keyed on the stable stage
        # identity, and a recorded routing decision ("stage:device");
        # units are the input size, so the learned rate scales with it
        op = "stage.run|" + hashlib.sha1(stable.encode()).hexdigest()[:12]
        with costmodel.timed(op, units=max(1.0, unit_size), routing_op="stage"):
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


# compiled stand-alone predicates, keyed structurally (an id() key could be
# recycled after GC and serve a stale predicate); False caches a decline
_filter_cache: Dict[tuple, object] = {}


def _compile_predicate(predicate, schema: pa.Schema):
    """(compiler, mask function) for a boolean predicate over `schema`, or
    False when it cannot lower to the device."""
    key = (str(predicate), tuple(schema.names), tuple(str(t) for t in schema.types))
    hit = _filter_cache.get(key)
    if hit is not None:
        return hit
    from ballista_tpu_torch.ops.torchexpr import ExprCompiler, predicate_fn

    try:
        compiler = ExprCompiler(schema, ScanDictionaries())
        cv = compiler.compile(predicate)
        if cv.kind != "bool":
            raise UnsupportedOnDevice("non-boolean predicate")
        # WHERE collapse: NULL -> excluded
        hit = (compiler, predicate_fn(cv))
    except UnsupportedOnDevice:
        hit = False
    _filter_cache[key] = hit
    return hit


def filter_batch(batch: pa.RecordBatch, predicate, device) -> Optional[pa.RecordBatch]:
    """Evaluate the predicate on `device` (one boolean mask per batch, one
    readback) and compact on the host. None when the predicate or a column
    cannot lower; the operator then filters on the host."""
    import torch

    hit = _compile_predicate(predicate, batch.schema)
    if hit is False:
        return None
    compiler, mask_fn = hit
    n = batch.num_rows
    bucket = bucket_rows(n)
    try:
        cols = {}
        for idx, dtype in compiler.used_columns.items():
            d = compiler.dicts.dicts.get(idx)
            npcol = column_to_numpy(batch.column(idx), dtype, d)
            fill = False if npcol.dtype == np.bool_ else 0
            cols[idx] = upload(pad_to(npcol, bucket, fill), device)
    except UnsupportedOnDevice as e:
        record_routing("host", "filter")
        return host_fallback(f"filter batch lowering: {e}")
    aux = [upload(np.asarray(a), device) for a in compiler.build_aux()]
    mask = torch.broadcast_to(torch.as_tensor(mask_fn(cols, aux), device=device),
                              (bucket,))
    # the boolean mask crosses to the host once per batch
    keep = readback(mask)[:n]
    return batch.filter(pa.array(keep))
