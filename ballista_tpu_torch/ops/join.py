"""Device join: sort + paired binary search with M:N multiplicity, on
PyTorch tensors (the JAX package's ``ops/join.py``, decision for decision).

Build-side key codes are sorted on the device once (a stable sort, so equal
keys keep build-row order); each probe key binary-searches the sorted plane
twice (``torch.searchsorted`` with side "left" and "right") and the
difference is that probe's match run-length. Run-lengths read back as one
int32 per probe slot; matches materialise through a bounded-width gather
[probe slots, width] whose width is the smallest admission tier
(ops/kernels.py::JOIN_MULTIPLICITY_TIERS) covering the largest run, read
back once and flattened on the host, probe-major.

The cost model (ops/costmodel.py) adds three escapes past the static
ladder, each bit-identical to the host oracle:

- extended tiers: with a warm store whose evidence says the device gather
  beats the host join (kernels.join_extended_tier), widths 512 / 1024
  admit under a hard cap; a gross mispredict re-tiers the store;
- partial offload: a join past a tier boundary SPLITS there: probes whose
  run fits the boundary tier gather on the device, the few dominant keys
  past it join on the host oracle, and the two selections merge
  probe-major, checked against the device run-lengths before the merge;
- build-side swap: when the planned build side has more than
  _BUILD_SWAP_RATIO times the probe's rows, the device sorts the smaller
  side and the probe-major order is restored on the host.

Shapes past every escape step aside to the host sort-merge join
(physical/joinutil.py) with a recorded reason. Both paths emit matches in
the same order (probe-major, build rows ascending within a probe key), so
device results are bit-identical to the host oracle. The probe side is
padded to ``bucket_rows(n, 16)`` slots as in the JAX package: the tier, the
split boundary and the cost units are taken on that slot count, so both
packages decide alike on the same input.

Every device step runs on the ``device`` its caller names (the operator's
ctx.device); a CUDA step either runs or raises. Every decline records its
path and reason (runtime.record_join_path) and a "join:host" routing event,
and never touches the stage routes of runtime.routing_stats(). Its
readbacks carry the site "join" (counters.readback's "join.*" keys), so a
caller can tell a stage's own readbacks from the join's.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import pyarrow as pa

from ballista_tpu_torch.ops.runtime import (
    bucket_rows,
    pad_to,
    readback,
    record_join_path,
    record_routing,
    record_routing_event,
    routing_probe,
    upload,
)
from ballista_tpu_torch.utils import tracing

_PAD_CODE = np.int32(2**31 - 1)  # sorts last, never matches a valid probe

# partial offload engages only for the skew shape it is built for: at most
# this many DISTINCT keys past the tier boundary go to the host remainder
_SPLIT_MAX_HOT_KEYS = 16
# planned-build-side row excess past which the observed cardinalities are
# treated as a plan-time misestimate and the build side switches
_BUILD_SWAP_RATIO = 4

def match_runs(sorted_codes, probe_codes):
    """Per-probe match run over a sorted build-code plane: paired
    searchsorted left / right -> (starts, counts), both int32. Null probe
    codes (-1) and probe pad slots yield count 0; null build codes sort
    below every valid probe code and build pad codes above, so
    [starts, ends) never spans either."""
    import torch

    starts = torch.searchsorted(sorted_codes, probe_codes, side="left", out_int32=True)
    ends = torch.searchsorted(sorted_codes, probe_codes, side="right", out_int32=True)
    counts = torch.where(probe_codes >= 0, ends - starts, 0)
    return starts, counts


def gather_matches(values, starts, counts, width: int):
    """Bounded-width gather: [P, width] of values[starts + j], set to -1
    past each probe's run length."""
    import torch

    n = values.shape[0]
    j = torch.arange(width, dtype=torch.int32, device=values.device)
    idx = (starts[:, None] + j[None, :]).clamp_(0, n - 1)
    return torch.where(j[None, :] < counts[:, None], values[idx.long()], -1)


def join_runs(build_codes, probe_codes):
    """The runs step: a stable sort of the build codes (equal keys keep
    build-row order, as the host oracle's stable argsort does), then
    match_runs. Returns (order int32, starts, counts)."""
    import torch

    sorted_codes, order = torch.sort(build_codes, stable=True)
    starts, counts = match_runs(sorted_codes, probe_codes)
    return order.to(torch.int32), starts, counts


def _decline(kind: str, reason: str) -> None:
    """Join decline: the path and reason (`kind` is "step_aside" for the
    admission tiers, "host_fallback" otherwise), a "join:host" routing
    event and the host-fallback trace. The join leaves the device
    entirely; the stage routes are not touched."""
    from ballista_tpu_torch.ops.kernels import host_fallback

    record_join_path(kind, reason)
    record_routing("host", "join")
    return host_fallback(reason)


def _counts_plane(build_codes: np.ndarray, probe_codes: np.ndarray, device):
    """Admission, padding and the runs step shared by both entries:
    (order, starts, counts [device], counts_h [host, unpadded], n_probe),
    or None after a recorded decline (empty side, codes past int32)."""
    nb, np_ = len(build_codes), len(probe_codes)
    if nb == 0 or np_ == 0:
        return _decline("host_fallback", "empty join side")
    hi = max(int(build_codes.max()), int(probe_codes.max()))
    if hi >= 2**31 - 2:
        return _decline("host_fallback", "join key codes exceed int32")
    b = upload(pad_to(build_codes.astype(np.int32), bucket_rows(nb, 16), _PAD_CODE), device)
    # null probe keys (-1) search below all valid codes and compare unequal:
    # already a non-match; pads reuse the same sentinel
    p = upload(pad_to(probe_codes.astype(np.int32), bucket_rows(np_, 16), -1), device)
    order, starts, counts = join_runs(b, p)
    counts_h = readback(counts, site="join")[:np_]
    return order, starts, counts, counts_h, np_


def _run_gather(order, starts, counts, tier: int, np_: int) -> Tuple[np.ndarray, float]:
    """The bounded-width gather at `tier`, read back, and its cost observed:
    (matched plane [np_, tier], seconds)."""
    from ballista_tpu_torch.ops import costmodel

    t0 = time.perf_counter()
    with tracing.span("join.gather"):
        mat = readback(gather_matches(order, starts, counts, tier), rows=np_,
                       site="join")[:np_]
    dt = time.perf_counter() - t0
    costmodel.observe("join.gather", int(counts.shape[0]) * tier, dt)
    return mat, dt


def _flatten_matched(mat: np.ndarray, counts_h: np.ndarray, np_: int):
    """Host flatten of the gathered plane into probe-major (build, probe)
    selections: the row-major compaction is the run-length scan."""
    with tracing.span("join.flatten"):
        tier = mat.shape[1]
        keep = np.arange(tier, dtype=np.int32)[None, :] < counts_h[:, None]
        build_idx = mat[keep].astype(np.int64)
        probe_idx = np.repeat(np.arange(np_, dtype=np.int64), counts_h)
        return build_idx, probe_idx


def _within_runs(counts: np.ndarray) -> np.ndarray:
    """[0..c) position index for each run of a counts vector, flattened."""
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    cum = np.cumsum(counts, dtype=np.int64)
    return np.arange(total, dtype=np.int64) - np.repeat(cum - counts, counts)


def _split_offload(
    order, starts, counts, counts_h, np_,
    build_codes: np.ndarray, probe_codes: np.ndarray,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Partial offload: probes whose run fits the largest cap-admissible
    tier gather on the device, the dominant keys past it (at most
    _SPLIT_MAX_HOT_KEYS distinct) join on the host oracle, and the
    selections merge probe-major. The host remainder's run-lengths are
    checked against the device counts before the merge. None when the
    shape is not a split candidate."""
    from ballista_tpu_torch.ops import costmodel
    from ballista_tpu_torch.ops.kernels import (
        JOIN_GATHER_CAP,
        JOIN_MULTIPLICITY_TIERS,
        join_multiplicity_tier,
    )
    from ballista_tpu_torch.physical.joinutil import join_indices

    probe_slots = int(counts.shape[0])
    boundary = JOIN_MULTIPLICITY_TIERS[0]
    for t in JOIN_MULTIPLICITY_TIERS:
        if t == 1 or probe_slots * t <= JOIN_GATHER_CAP:
            boundary = t
    hot = counts_h > boundary
    if not hot.any():
        return None  # nothing past the boundary: not this escape's shape
    if len(np.unique(probe_codes[hot])) > _SPLIT_MAX_HOT_KEYS:
        return None  # broad duplication, not skew: splitting buys nothing
    cold = ~hot
    cold_max = int(counts_h[cold].max()) if cold.any() else 0
    cold_tier, _why = join_multiplicity_tier(cold_max, probe_slots)
    if cold_tier is None or cold_tier > boundary:
        return None
    # input-row units, like every other join.host observation
    host_units = len(build_codes) + int(hot.sum())
    predicted = None
    dev_pred = costmodel.predict("join.gather", probe_slots * cold_tier)
    host_pred = costmodel.predict("join.host", host_units, engine="host")
    if dev_pred is not None and host_pred is not None:
        predicted = dev_pred + host_pred

    mat, dt_dev = _run_gather(order, starts, counts, cold_tier, np_)
    # host remainder: the oracle on the hot probes only
    hot_sel = np.flatnonzero(hot)
    t_host = time.perf_counter()
    bi_hot, pi_hot = join_indices(build_codes, probe_codes[hot_sel], "inner")
    dt_host = time.perf_counter() - t_host
    costmodel.observe("join.host", host_units, dt_host, engine="host")
    costmodel.check_mispredict("join.gather", probe_slots * cold_tier, dev_pred, dt_dev)
    costmodel.check_mispredict("join.host", host_units, host_pred, dt_host, engine="host")
    # the host remainder's run-lengths must equal the device counts for
    # those probes; if the two engines disagree the split must not merge
    hot_counts = counts_h[hot_sel].astype(np.int64)
    if len(bi_hot) != int(hot_counts.sum()) or not np.array_equal(
        np.bincount(pi_hot, minlength=len(hot_sel)), hot_counts
    ):
        record_routing_event("split_oracle_mismatch")
        return None

    offsets = np.concatenate(([0], np.cumsum(counts_h, dtype=np.int64)[:-1]))
    total = int(counts_h.sum())
    build_idx = np.empty(total, dtype=np.int64)
    cold_sel = np.flatnonzero(cold)
    cold_counts = counts_h[cold_sel].astype(np.int64)
    keep_cold = (
        np.arange(cold_tier, dtype=np.int32)[None, :] < counts_h[:, None]
    ) & cold[:, None]
    build_idx[
        np.repeat(offsets[cold_sel], cold_counts) + _within_runs(cold_counts)
    ] = mat[keep_cold].astype(np.int64)
    build_idx[
        np.repeat(offsets[hot_sel], hot_counts) + _within_runs(hot_counts)
    ] = bi_hot
    probe_idx = np.repeat(np.arange(np_, dtype=np.int64), counts_h)
    record_join_path("split", "partial offload at the tier boundary")
    # observed = the modelled work (gather + host join), not the merge
    record_routing("split", "join", predicted, dt_dev + dt_host)
    record_routing_event("split")
    return build_idx, probe_idx, counts_h.astype(np.int64)


def _extended_gather(
    order, starts, counts, counts_h, np_,
    max_mult: int, host_units: int,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Evidence-gated gather at an extended tier (past the static ladder).
    A gross mispredict re-tiers the store, so the next decision for this
    bucket falls back to the static prior."""
    from ballista_tpu_torch.ops import costmodel
    from ballista_tpu_torch.ops.kernels import join_extended_tier

    probe_slots = int(counts.shape[0])
    ext = join_extended_tier(max_mult, probe_slots, host_units)
    if ext is None:
        return None
    tier, dev_pred, _host_pred = ext
    mat, dt = _run_gather(order, starts, counts, tier, np_)
    record_routing("device", "join.extended", dev_pred, dt)
    costmodel.check_mispredict("join.gather", probe_slots * tier, dev_pred, dt)
    build_idx, probe_idx = _flatten_matched(mat, counts_h, np_)
    record_join_path("device", "extended tier past the static ladder")
    return build_idx, probe_idx, counts_h.astype(np.int64)


def device_join_indices(
    build_codes: np.ndarray, probe_codes: np.ndarray, device, config=None
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """M:N inner-join row selections computed on `device`.

    Returns (build_idx, probe_idx, counts): flat int64 selections of every
    (build, probe) key match, probe-major with build rows in stable order
    within a probe key (bit-identical to the host oracle's
    ``join_indices(..., "inner")``), plus per-probe match run-lengths. None
    when the device declines (empty side, codes past int32, multiplicity
    past the top tier); every decline records its reason.

    With a config whose ``ballista.tpu.cost_model`` is on, shapes the static
    ladder declines first try the extended tier, then the split; without
    one the static ladder is the whole story.
    """
    from ballista_tpu_torch.ops import costmodel
    from ballista_tpu_torch.ops.kernels import join_multiplicity_tier

    plane = _counts_plane(build_codes, probe_codes, device)
    if plane is None:
        return None  # reason recorded by _counts_plane's decline
    order, starts, counts, counts_h, np_ = plane
    max_mult = int(counts_h.max())
    probe_slots = int(counts.shape[0])
    tier, why = join_multiplicity_tier(max_mult, probe_slots)
    if tier is not None:
        predicted = costmodel.predict("join.gather", probe_slots * tier)
        mat, dt = _run_gather(order, starts, counts, tier, np_)
        build_idx, probe_idx = _flatten_matched(mat, counts_h, np_)
        record_join_path("device")
        record_routing("device", "join", predicted, dt)
        # a gross mispredict either way re-tiers the bucket: a first-call
        # outlier would otherwise skew the rate for many observations
        costmodel.check_mispredict("join.gather", probe_slots * tier, predicted, dt)
        return build_idx, probe_idx, counts_h.astype(np.int64)
    if config is not None and config.tpu_cost_model():
        costmodel.configure(config)
        host_units = len(build_codes) + len(probe_codes)
        res = _extended_gather(order, starts, counts, counts_h, np_, max_mult, host_units)
        if res is None:
            res = _split_offload(order, starts, counts, counts_h, np_,
                                 build_codes, probe_codes)
        if res is not None:
            return res
    return _decline("step_aside", why)


def device_membership_counts(
    build_codes: np.ndarray, probe_codes: np.ndarray, device
) -> Optional[np.ndarray]:
    """Per-probe match run-lengths computed on `device`: the counts-only
    entry of device_join_indices, for LEFT-join COUNT aggregates and
    SEMI/ANTI membership. No gather, so no multiplicity tier applies; the
    readback is one int32 per probe slot. Returns int64 counts (null probe
    codes yield 0), or None after a recorded decline (empty side, codes
    past int32)."""
    plane = _counts_plane(build_codes, probe_codes, device)
    if plane is None:
        return None  # reason recorded by _counts_plane's decline
    counts_h = plane[3]
    record_join_path("device")
    record_routing("device", "join.counts")
    return counts_h.astype(np.int64)


def try_device_inner_join(
    build: pa.Table,
    probe: pa.Table,
    build_keys: list,
    probe_keys: list,
    device,
    config=None,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(build_idx, probe_idx) row selections of the inner join, duplicate
    build keys expanded to their full multiplicity, or None if the device
    declines.

    With the cost model on, a planned build side more than
    _BUILD_SWAP_RATIO times the probe's rows swaps sides (the device sorts
    the smaller plane) and the probe-major order is restored on the host:
    within a probe key every matched build row has the same key code, so a
    stable sort of the swapped result by probe row gives the oracle's
    order exactly."""
    from ballista_tpu_torch.physical.joinutil import combined_key_codes

    bcodes, pcodes = combined_key_codes(
        [build.column(k) for k in build_keys],
        [probe.column(k) for k in probe_keys],
    )
    if (
        config is not None
        and config.tpu_cost_model()
        and len(bcodes) > _BUILD_SWAP_RATIO * max(1, len(pcodes))
    ):
        # the swapped shape may decline; the planned-side attempt below
        # then records the real decision, so the probe's records are
        # committed only when the swapped attempt produced the result
        with routing_probe() as rp:
            swapped = device_join_indices(pcodes, bcodes, device, config)
        if swapped is not None:
            rp.commit()
            record_routing_event("join_build_swapped")
            p_rows, b_rows, _counts = swapped
            perm = np.argsort(p_rows, kind="stable")
            return b_rows[perm], p_rows[perm]
    res = device_join_indices(bcodes, pcodes, device, config)
    if res is None:
        return None
    build_idx, probe_idx, _counts = res
    return build_idx, probe_idx
