"""Fused stage execution on the "cuda" backend.

The pipeline under an aggregation — scan -> filter* -> projection -> partial
aggregate — runs as one device step per batch (ops/stage.py of the JAX
package, ported to PyTorch):

    host: Arrow IO, dictionary-encode strings, evaluate group keys, rank
          group codes (np.unique), narrow and upload the used columns
    device: filter predicates -> mask; aggregate-input arithmetic; masked
          per-group count/sum/min/max into partial states

Per-batch partial states assemble into a standard partial-aggregate table,
so the surrounding Partial/Final machinery is unchanged.

Three device routes, named as in the JAX package so both report the same
route:
- "batches": up to MAX_GROUPS groups per batch. Plain PyTorch: a [G, N]
  group-membership mask and one masked reduction per aggregate.
- "sorted" (the default past MAX_GROUPS): the whole partition in the
  chunked-segment layout (ops/layout.py). Rows are sorted by group rank on
  the host and laid out as [V, L1] tiles of at most L1 rows of one group;
  the device step reduces along axis 1 to per-chunk partials (plain
  PyTorch), and the host folds chunks to groups. Integer states sum in
  int32 on the device under _check_int_ranges against L1, the reference's
  bound for one chunk. A stage with the planner's Sort+Limit annotation
  (_topk_pushdown) prepares this route directly and, where the layout gives
  exact per-group states, finishes with the fused top-k epilogue: the
  device ranks the groups and reads back k of them (_run_topk).
- "pallas_sorted": high-cardinality sum/count/avg stages under
  ``ballista.tpu.sorted_kernel=pallas``. Rows are sorted by dense group rank
  on the host and summed per group by the hand-written CUDA kernel
  ``sorted_grouped_sum`` (ops/cuda_kernels.py, csrc/sorted_grouped_sum.cu).

Not ported yet: the persisted layout cache (ops/layout_cache.py) and the
fact-aggregate hooks of the "sorted" route.

Readback: the "batches" route reads int32 and float32 state rows back as two
transfers per run; the "sorted" route and the top-k epilogue read one int32
array in which float rows travel bit-cast (the JAX package split int32 rows
into f32 halves because its TPU flushed denormals; a bit-cast is exact
here).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from ballista_tpu_torch.ops.runtime import (
    ScanDictionaries,
    UnsupportedOnDevice,
    bucket_rows,
    check_budget,
    column_to_numpy,
    narrow_column,
    pad_to,
    readback,
    record_route,
    upload,
    widen_cols,
)
from ballista_tpu_torch.ops.torchexpr import ExprCompiler
from ballista_tpu_torch.physical import expr as px
from ballista_tpu_torch.physical.basic import (
    CoalesceBatchesExec,
    FilterExec,
    MergeExec,
    ProjectionExec,
)
from ballista_tpu_torch.physical.scan import CsvScanExec, MemoryScanExec, ParquetScanExec

_SCAN_TYPES = (CsvScanExec, ParquetScanExec, MemoryScanExec)


def plane_keys(idx: int) -> Tuple[int, int]:
    """cols-dict keys for scan column idx's order-preserving int32 key
    planes (ops/floatbits.py). Negative ints, so they share one dict with
    the non-negative scan column indices. f32 columns use the hi slot only;
    f64 columns carry (hi, lo) whose lexicographic signed order is the f64
    total order."""
    return -2 * idx - 2, -2 * idx - 3


# ceiling for the per-batch "batches" route; beyond it the stage switches to
# a sorted route
MAX_GROUPS = 1024

# the "pallas_sorted" route carries counts as f32 rows: exact only up to
# 2^24 rows per stage; larger partitions take the "sorted" layout route
SORTED_KERNEL_MAX_ROWS = 1 << 24

_INT32_MAX = 2**31 - 1

# widest one-chunk-per-group cover the fused top-k epilogue will force;
# beyond it (or past 4x row padding) the default chunking runs and the
# epilogue's fold variant takes over. HARD CEILING: the layout's clen and
# expand_clen's arange are int16, so an L1 past 2^14 would wrap chunk
# lengths silently.
TOPK_MAX_L1 = 1 << 14


def _topk_cover_L1(codes: np.ndarray, n_groups: int) -> Optional[int]:
    """L1 giving the one-chunk-per-group cover the fused top-k epilogue
    needs: the chunk fold becomes identity, so the k gathered columns are
    bit-identical to what the full readback would emit. None when the
    longest run exceeds TOPK_MAX_L1 or the cover's zero padding would blow
    past ~4x the real rows (skewed runs) — the caller falls back to the
    default chunking and fusion disables for the partition."""
    if n_groups <= 0:
        return None
    longest = int(np.bincount(codes, minlength=n_groups).max())
    L1 = 8
    while L1 < longest:
        L1 <<= 1
    if L1 > TOPK_MAX_L1 or n_groups * L1 > max(4 * len(codes), 1 << 22):
        return None
    return L1


# the skew handler splits at most this many dominant groups to the
# epilogue's segment fold; distributions where more groups blow the cover
# are broad, not skewed, and keep the default chunking
SKEW_MAX_DOMINANT = 64


def skew_split_plan(codes: np.ndarray, n_groups: int) -> Optional[Tuple[int, int]]:
    """Called when the one-chunk-per-group cover fails: detect the few
    dominant groups whose runs blow the cover bounds and pick the cover
    from the TAIL run distribution instead. L1 covers every non-dominant
    run (those groups keep one chunk each, an identity fold); the dominant
    runs split across chunks and segment-fold in the epilogue. Returns
    (L1, n_dominant), or None when at most SKEW_MAX_DOMINANT dominants
    cannot satisfy the bounds (the caller keeps the default chunking)."""
    if n_groups <= 1:
        return None
    lens = np.sort(np.bincount(codes, minlength=n_groups))[::-1]
    budget = max(4 * len(codes), 1 << 22)
    for n_dom in range(1, min(SKEW_MAX_DOMINANT, n_groups - 1) + 1):
        tail_max = int(lens[n_dom])
        L1 = 8
        while L1 < tail_max:
            L1 <<= 1
        if L1 > TOPK_MAX_L1:
            continue  # even the tail needs a wider cover: more dominants
        dom_chunks = int(np.sum(-(-lens[:n_dom] // L1)))
        if (n_groups - n_dom + dom_chunks) * L1 <= budget:
            return L1, n_dom
    return None


def expand_clen(clen, L1: int):
    """[V, L1] valid-slot mask from the int16 per-chunk lengths, built on the
    device (shipping the bool tiles would cost one byte per slot)."""
    import torch

    return torch.arange(L1, dtype=torch.int16, device=clen.device)[None, :] < clen[:, None]


class TooManyGroups(UnsupportedOnDevice):
    """Internal signal: the "batches" route declined on cardinality; run()
    retries with a sorted route before giving up."""


def _rows_like(v, mask):
    """Broadcast a value (a per-row tensor, or a 0-dim literal that may sit
    on the CPU) to the mask's shape and device."""
    if v.device != mask.device:
        v = v.to(mask.device)
    if v.shape != mask.shape:
        v = v.expand(mask.shape)
    return v


def dense_rank(encoded: List[Tuple[np.ndarray, int]]):
    """Combine per-column dictionary codes into dense row ranks.

    encoded: (int64 code array, alphabet size) per key column, all arrays the
    same length. Strides are combined with an overflow guard (repack through
    np.unique before a multiply could overflow int64). Returns
    (rank per row, first row index of each distinct, distinct count)."""
    combined = None
    card = 1
    for codes_i, size in encoded:
        size = max(1, size)
        if combined is None:
            combined, card = codes_i, size
            continue
        if card > (1 << 62) // size:
            _, combined = np.unique(combined, return_inverse=True)
            combined = combined.astype(np.int64)
            card = int(combined.max()) + 1 if len(combined) else 1
        combined = combined * size + codes_i
        card *= size
    uniq, first_idx, inv = np.unique(
        combined, return_index=True, return_inverse=True
    )
    return inv, first_idx, len(uniq)


def substitute_columns(e: px.PhysicalExpr, mapping: List[px.PhysicalExpr]) -> px.PhysicalExpr:
    """Inline projection outputs: ColumnExpr(i) -> mapping[i]."""
    if isinstance(e, px.ColumnExpr):
        return mapping[e.index]
    if isinstance(e, px.LiteralExpr):
        return e
    if isinstance(e, px.BinaryPhysicalExpr):
        return px.BinaryPhysicalExpr(
            substitute_columns(e.left, mapping), e.op, substitute_columns(e.right, mapping)
        )
    if isinstance(e, px.NotExpr):
        return px.NotExpr(substitute_columns(e.expr, mapping))
    if isinstance(e, px.NegativeExpr):
        return px.NegativeExpr(substitute_columns(e.expr, mapping))
    if isinstance(e, px.IsNullExpr):
        return px.IsNullExpr(substitute_columns(e.expr, mapping), e.negated)
    if isinstance(e, px.CastExpr):
        return px.CastExpr(substitute_columns(e.expr, mapping), e.dtype, e.safe)
    if isinstance(e, px.InListExpr):
        return px.InListExpr(
            substitute_columns(e.expr, mapping),
            e.values,
            e.negated,
            None
            if e.value_exprs is None
            else [substitute_columns(v, mapping) for v in e.value_exprs],
        )
    if isinstance(e, px.BetweenExpr):
        return px.BetweenExpr(
            substitute_columns(e.expr, mapping),
            substitute_columns(e.low, mapping),
            substitute_columns(e.high, mapping),
            e.negated,
        )
    if isinstance(e, px.CaseExpr):
        return px.CaseExpr(
            None if e.base is None else substitute_columns(e.base, mapping),
            [
                (substitute_columns(w, mapping), substitute_columns(t, mapping))
                for w, t in e.when_then
            ],
            None if e.else_expr is None else substitute_columns(e.else_expr, mapping),
            e.dtype,
        )
    if isinstance(e, px.ScalarFunctionExpr):
        return px.ScalarFunctionExpr(
            e.fn, [substitute_columns(a, mapping) for a in e.args], e.dtype
        )
    raise UnsupportedOnDevice(f"cannot inline {type(e).__name__}")


def state_column(a, raw: np.ndarray, target: pa.DataType,
                 empty_mask: Optional[np.ndarray]) -> pa.Array:
    """Cast one decoded aggregate-state row to its partial-schema field.
    min/max rows null out empty groups (sentinel fills) via empty_mask;
    date32 states ride as exact int32 day counts (pyarrow has no
    double->date32 cast). Shared by every device assembly path."""
    if a.fn in ("min", "max"):
        if pa.types.is_date32(target):
            arr = pa.array(raw.astype(np.int32), mask=empty_mask)
        else:
            arr = pa.array(raw.astype(np.float64), mask=empty_mask)
    else:
        arr = pa.array(raw.astype(np.float64))
    if arr.type != target:
        arr = pc.cast(arr, target)
    return arr


class FusedAggregateStage:
    """Device pipeline for one HashAggregateExec (partial phase)."""

    def __init__(self, agg, float_bits: bool = True) -> None:
        from ballista_tpu_torch.physical.aggregate import AggregateFunc

        # --- walk the operator chain down to the row source --------------
        # Filters/projections fuse onto the device; whatever sits below them
        # (a scan, or e.g. a host hash join) becomes the row source — so a
        # join-under-aggregate still gets device aggregation.
        node = agg.input
        stack: List[Tuple[str, object]] = []
        # scan_stride: when set to N, this stage's logical partition p reads
        # scan partitions p, p+N, p+2N, ... — used when the partition count
        # the framework drives (aggregate input partitioning) differs from
        # the scan's own count. Crossing a MergeExec (row-transparent; the
        # coalesced SINGLE-mode plan) means ONE driven partition covers
        # every scan partition: stride 1.
        self.scan_stride: Optional[int] = None
        while isinstance(node, (FilterExec, ProjectionExec, CoalesceBatchesExec, MergeExec)):
            if isinstance(node, FilterExec):
                stack.append(("filter", node.predicate))
                node = node.input
            elif isinstance(node, ProjectionExec):
                stack.append(("project", node.exprs))
                node = node.input
            else:
                if isinstance(node, MergeExec):
                    self.scan_stride = 1
                node = node.input
        if self.scan_stride is None:
            # a rewritten aggregate (ops/mappedscan.py) whose driven
            # partition count differs from its scan's: stripe the scan
            hint = getattr(agg, "_scan_stride_hint", None)
            if hint is not None:
                self.scan_stride = int(hint)
        self.scan = node
        # device columns stay resident only for file-backed scans (stable
        # data identity); other sources re-execute per query.
        # ballista_cacheable: composed row sources (ops/mappedscan.py) whose
        # data identity is still file-backed opt in via the class attribute
        self.cacheable = isinstance(node, _SCAN_TYPES) or getattr(
            node, "ballista_cacheable", False
        )
        scan_schema = node.schema()

        # --- re-express every expression against the scan schema --------
        mapping: List[px.PhysicalExpr] = [
            px.ColumnExpr(f.name, i) for i, f in enumerate(scan_schema)
        ]
        filters: List[px.PhysicalExpr] = []
        for kind, payload in reversed(stack):
            if kind == "project":
                mapping = [substitute_columns(e, mapping) for e, _ in payload]
            else:
                filters.append(substitute_columns(payload, mapping))
        # input-schema -> scan-schema expr map, exposed for composers
        # (FactAggregateStage re-expresses extra columns through it)
        self.input_to_scan = mapping

        self.group_exprs = [
            (substitute_columns(e, mapping), name) for e, name in agg.group_exprs
        ]
        self.aggs: List[AggregateFunc] = []
        self.agg_inputs: List[px.PhysicalExpr] = []
        for a in agg.aggr_funcs:
            if a.fn not in ("sum", "min", "max", "avg", "count"):
                raise UnsupportedOnDevice(f"aggregate {a.fn}")
            self.aggs.append(a)
            self.agg_inputs.append(substitute_columns(a.expr, mapping))

        # --- compile device code ----------------------------------------
        self.dicts = ScanDictionaries()
        self.compiler = ExprCompiler(scan_schema, self.dicts)
        self.filter_fns = [self.compiler.compile(f) for f in filters]
        for f in self.filter_fns:
            if f.kind != "bool":
                raise UnsupportedOnDevice("non-boolean filter")
        # WHERE collapse: predicates whose SQL value is NULL exclude the row
        # (three-valued logic over -1 string codes, torchexpr.predicate_fn)
        from ballista_tpu_torch.ops.torchexpr import predicate_fn

        self.filter_masks = [predicate_fn(f) for f in self.filter_fns]
        self.value_fns = []
        # integer-typed plain-column inputs accumulate in int32 on device
        # (exact, vs the f32 rounding ADVICE r1 flagged); the value range is
        # bound-checked at prepare time and declines when int32 could
        # overflow a whole-batch masked sum
        self.int_exact: List[bool] = []
        # float MIN/MAX over a plain column routes through the
        # order-preserving bijection (ops/floatbits.py): the column's bits
        # travel as int32 key planes, integer min/max is exact on device,
        # and the readback inverts — bit-exact against the stored f64/f32
        # value, so q2's equality-joined MIN needs no decline. Entries:
        # None (f32 arithmetic path) | "f32" (one plane) | "f64" (hi/lo).
        # The mesh path opts out (float_bits=False): its collectives fold
        # rows independently, which cannot express the hi/lo lexicographic
        # pair, and it keeps its documented f32 min/max semantics.
        self.float_bits: List[Optional[str]] = []
        # scan column index -> "f32" | "f64" (plane columns to materialize)
        self._bit_planes: Dict[int, str] = {}
        exact_required = bool(getattr(agg, "exact_floats", False))
        for a, ie in zip(self.aggs, self.agg_inputs):
            if a.fn == "count":
                # COUNT counts NON-NULL inputs; the device mask-count would
                # count null strings (-1 codes). Wildcard/literal inputs
                # (COUNT(*)) and null-free numeric columns are safe.
                if not isinstance(ie, px.LiteralExpr):
                    probe = self.compiler.compile(ie)
                    if probe.kind == "code":
                        raise UnsupportedOnDevice("COUNT over a string column")
                self.value_fns.append(None)  # mask count only
                self.int_exact.append(False)
                self.float_bits.append(None)
                continue
            if (
                float_bits
                and a.fn in ("min", "max")
                and isinstance(ie, px.ColumnExpr)
                and pa.types.is_floating(scan_schema.field(ie.index).type)
            ):
                # bijected path: do NOT compile the input (that would upload
                # the rounded f32 copy even when nothing else reads it); the
                # planes are materialized directly from the Arrow column
                width = (
                    "f32"
                    if pa.types.is_float32(scan_schema.field(ie.index).type)
                    else "f64"
                )
                prior = self._bit_planes.setdefault(ie.index, width)
                if prior != width:
                    raise UnsupportedOnDevice("conflicting float plane widths")
                self.value_fns.append(None)
                self.int_exact.append(False)
                self.float_bits.append(width)
                continue
            cv = self.compiler.compile(ie)
            if cv.kind == "code":
                raise UnsupportedOnDevice("string aggregate input")
            if (
                exact_required
                and a.fn in ("min", "max")
                and pa.types.is_floating(a.input_type)
            ):
                # equality-consumed float MIN/MAX over a COMPUTED expression:
                # only plain columns carry exact bits; f32 arithmetic would
                # round the result so it matches nothing — host path
                raise UnsupportedOnDevice(
                    "exact float min/max over a computed expression"
                )
            self.value_fns.append(cv)
            # dates lower as int32 day counts: exact int min/max (the
            # f32 route crashed assembling double -> date32, and values
            # past 2^24 days would round)
            self.int_exact.append(
                isinstance(ie, px.ColumnExpr)
                and (
                    pa.types.is_integer(scan_schema.field(ie.index).type)
                    or pa.types.is_date32(scan_schema.field(ie.index).type)
                )
            )
            self.float_bits.append(None)
        self.scan_schema = scan_schema
        self.partial_schema = agg.schema() if agg.mode.value == "partial" else self._partial_schema(agg)
        self._int_rows, self._folds, self._state_specs = self._plan_outputs()
        # planner-annotated Sort+Limit epilogue (physical/planner.py): when
        # eligible, the "sorted" step finishes with a device top-k over the
        # group scores and reads back `limit` rows instead of every group.
        # Only SINGLE-mode aggregates carry the annotation, so one partial IS
        # the final per-group state and device selection equals host
        # selection (boundary ties fall back per query, see _run_topk).
        self.topk: Optional[dict] = self._topk_spec(agg)
        # partition -> prepared device entry ({"kind": "batches" | "sorted" |
        # "pallas_sorted" | "empty", ...}); see ops/state.py for its layout
        self._device_cache: Dict[int, dict] = {}
        # narrow-residency choice of the first batch, keyed by col index;
        # kept stable across batches/partitions (mutated only under
        # _prepare_lock)
        self._narrow_choice: Dict[object, str] = {}
        # executor task threads can run different partitions of one cached
        # stage concurrently; prepare mutates shared state (the growing
        # ColumnDictionary, narrow choices), so it is serialized
        self._prepare_lock = threading.Lock()
        # the torch.device this stage's tensors live on (set on first run;
        # the stage cache key includes the device)
        self.device = None

    @staticmethod
    def _partial_schema(agg) -> pa.Schema:
        group_fields = []
        in_schema = agg.input.schema()
        for e, name in agg.group_exprs:
            group_fields.append(pa.field(name, e.data_type(in_schema)))
        state_fields = [f for a in agg.aggr_funcs for f in a.state_fields()]
        return pa.schema(group_fields + state_fields)

    # ------------------------------------------------------------------
    def _plan_outputs(self):
        """Stacked-output plan shared by both device steps: row 0 is counts,
        then one row per aggregate state column — except f64-bijected
        min/max states, which occupy TWO int32 rows (hi/lo key planes whose
        lexicographic order is the f64 total order). Returns (is_int flags,
        fold op names) per stacked row, plus one spec per partial-state
        FIELD: (first logical row, kind, fold) with kind in
        {"int", "num", "f32bits", "f64bits"} — the single source of truth
        for row -> state-column mapping (postprocess_state_rows,
        _fold_state_rows, the top-k epilogues, factagg's score row)."""
        int_rows = [True]  # counts
        folds = ["sum"]
        specs: List[Tuple[int, str, str]] = []
        for a, ix, fb in zip(self.aggs, self.int_exact, self.float_bits):
            row = len(int_rows)
            if a.fn == "count":
                int_rows.append(True)
                folds.append("sum")
                specs.append((row, "int", "sum"))
            elif a.fn in ("sum", "avg"):
                int_rows.append(ix)
                folds.append("sum")
                specs.append((row, "int" if ix else "num", "sum"))
                if a.fn == "avg":
                    int_rows.append(True)
                    folds.append("sum")
                    specs.append((row + 1, "int", "sum"))
            elif fb == "f64":
                int_rows.extend([True, True])
                folds.extend([a.fn, a.fn])  # pair; never folded per-row
                specs.append((row, "f64bits", a.fn))
            elif fb == "f32":
                int_rows.append(True)
                folds.append(a.fn)
                specs.append((row, "f32bits", a.fn))
            else:  # min / max, arithmetic path
                int_rows.append(ix)
                folds.append(a.fn)
                specs.append((row, "int" if ix else "num", a.fn))
        return int_rows, folds, specs

    # keys wider than this decline the fusion: each f64-bijected key spends
    # TWO of the lexicographic int32 lanes the device sort ranks over
    TOPK_MAX_KEY_LANES = 6

    def _topk_spec(self, agg) -> Optional[dict]:
        """Validate the planner's `_topk_pushdown` annotation against this
        stage's output plan. Returns the enriched spec or None (ineligible:
        the normal full-readback path runs unchanged).

        Every sort key lowers to int32 lanes whose signed order equals the
        key's order — exact int states as-is, f32 scores through the
        floatbits bijection, f64-bijected min/max as their (hi, lo) plane
        pair — so the device ranks one lexicographic int tuple. The group
        index is the final lane: ties then resolve to the lowest group
        exactly like the host's stable sort over the group-ordered
        aggregate output, which makes the device selection identical to the
        host Sort+Limit whenever the annotation covers every sort key."""
        tk = getattr(agg, "_topk_pushdown", None)
        if tk is None:
            return None
        mode = getattr(agg, "mode", None)
        if mode is not None and mode.value != "single":
            return None  # a per-partition partial top-k ranks partial sums
        if not (1 <= tk["k"] <= (1 << 16)):
            return None
        key_dicts = tk.get("keys") or [
            {"agg_index": tk["agg_index"], "descending": tk["descending"]}
        ]
        keyspecs: List[Tuple[int, str, bool]] = []
        for kd in key_dicts:
            j = kd.get("agg_index", -1)
            if not (0 <= j < len(self.aggs)):
                return None
            if self.aggs[j].fn not in ("sum", "count", "min", "max"):
                # avg finalizes to a RATIO of its two state rows; ranking
                # the sum row would order by the wrong quantity
                return None
            field_idx = sum(len(a.state_fields()) for a in self.aggs[:j])
            row, kind, _fold = self._state_specs[field_idx]
            keyspecs.append((row, kind, bool(kd["descending"])))
        n_lanes = sum(2 if kind == "f64bits" else 1 for _r, kind, _d in keyspecs)
        if not keyspecs or n_lanes > self.TOPK_MAX_KEY_LANES:
            return None
        covered = bool(tk.get("covered", not tk.get("strict", False)))
        return {
            "k": int(tk["k"]),
            "keys": keyspecs,
            "covered": covered,
            "n_lanes": n_lanes,
        }

    # -- "batches" route: the per-batch device step ----------------------
    def _batch_step(self, num_segments: int, cols, aux, codes, row_valid):
        """One batch's fused step (the JAX package's _unrolled_core): widen
        the narrow columns, AND the filter masks, send masked-out rows to
        the dump group num_segments - 1, and reduce every aggregate per
        group over a [G, N] membership mask. Integer states are int32
        (exact: the sums are range-checked at prepare time). Returns the
        int32 rows [R_int, G] and the f32 rows [R_f, G] (None when no
        state row is a float)."""
        import torch

        cols = widen_cols(cols)
        codes = codes.to(torch.int32)
        mask = row_valid
        for fm in self.filter_masks:
            mask = torch.logical_and(mask, fm(cols, aux))
        safe = torch.where(mask, codes, num_segments - 1)
        groups = torch.arange(num_segments, dtype=torch.int32, device=safe.device)
        member = safe[None, :] == groups[:, None]  # [G, N]

        def reduce_sum(v, zero):
            return torch.where(member, v[None, :], zero).sum(dim=1, dtype=v.dtype)

        def reduce_extreme(v, fill, red):
            w = torch.where(member, v[None, :], fill)
            return w.amax(dim=1) if red == "max" else w.amin(dim=1)

        def reduce_extreme_pair(hi, lo, fill, red):
            # lexicographic (hi, lo) extreme per group: lo competes only
            # among rows whose hi equals the group's hi extreme
            h = reduce_extreme(hi, fill, red)
            w = torch.where(
                torch.logical_and(member, hi[None, :] == h[:, None]), lo[None, :], fill
            )
            l = w.amax(dim=1) if red == "max" else w.amin(dim=1)
            return h, l

        rows = self._emit_rows(
            cols, aux, mask,
            counts=member.sum(dim=1, dtype=torch.int32),
            reduce_sum=reduce_sum,
            reduce_extreme=reduce_extreme,
            reduce_extreme_pair=reduce_extreme_pair,
        )
        ints = torch.stack([r for r, is_int in zip(rows, self._int_rows) if is_int])
        floats = [r for r, is_int in zip(rows, self._int_rows) if not is_int]
        return ints, (torch.stack(floats) if floats else None)

    def _emit_rows(self, cols, aux, mask, counts, reduce_sum, reduce_extreme,
                   reduce_extreme_pair):
        """Per-aggregate emission in the row order of _plan_outputs: int32
        rows for counts, int-exact states and float-bijected min/max key
        planes; f32 rows for the arithmetic path. Masked-out rows use 0 for
        sums and +/-extreme fills for min/max. With NaN declined at
        prepare, real keys never reach the int32 extremes, so the fills
        stay out-of-band."""
        import torch

        maskf = mask.to(torch.float32)
        rows = [counts]
        for a, ie, vf, ix, fb in zip(
            self.aggs, self.agg_inputs, self.value_fns, self.int_exact,
            self.float_bits,
        ):
            if a.fn == "count":
                rows.append(counts)
                continue
            if fb is not None:
                largest = a.fn == "max"
                fill = -_INT32_MAX - 1 if largest else _INT32_MAX
                red = "max" if largest else "min"
                hk, lk = plane_keys(ie.index)
                hi = torch.where(mask, _rows_like(cols[hk], mask), fill)
                if fb == "f32":
                    rows.append(reduce_extreme(hi, fill, red))
                else:
                    lo = torch.where(mask, _rows_like(cols[lk], mask), fill)
                    rows.extend(reduce_extreme_pair(hi, lo, fill, red))
                continue
            v = _rows_like(vf.fn(cols, aux), mask)
            if a.fn in ("sum", "avg"):
                if ix:
                    rows.append(reduce_sum(torch.where(mask, v.to(torch.int32), 0), 0))
                else:
                    rows.append(reduce_sum(v.to(torch.float32) * maskf, 0.0))
                if a.fn == "avg":
                    rows.append(counts)
            elif a.fn in ("min", "max"):
                largest = a.fn == "max"
                if ix:
                    fill = -_INT32_MAX - 1 if largest else _INT32_MAX
                    v2 = torch.where(mask, v.to(torch.int32), fill)
                else:
                    fill = float("-inf") if largest else float("inf")
                    v2 = torch.where(mask, v.to(torch.float32), fill)
                rows.append(reduce_extreme(v2, fill, "max" if largest else "min"))
        return rows

    # -- "sorted" route: the chunked-segment layout step -----------------
    def _sorted_step(self, L1: int, cols, aux, clen):
        """The JAX package's _sorted_core: elementwise expressions over the
        [V, L1] tiles, then axis-1 reductions to per-chunk partials, O(N)
        for any group count. The valid-slot mask expands on the device from
        the per-chunk lengths. Returns the logical rows of _plan_outputs,
        each [V]: int32 (sums exact under _check_int_ranges against L1) or
        f32."""
        import torch

        cols = widen_cols(cols)
        mask = expand_clen(clen, L1)
        for fm in self.filter_masks:
            mask = torch.logical_and(mask, fm(cols, aux))

        def reduce_extreme(v, fill, red):
            return v.amax(dim=1) if red == "max" else v.amin(dim=1)

        def reduce_extreme_pair(hi, lo, fill, red):
            # lexicographic (hi, lo) extreme per chunk: lo competes only
            # among slots whose hi equals the chunk's hi extreme (masked
            # slots carry fill in both planes)
            h = reduce_extreme(hi, fill, red)
            return h, reduce_extreme(torch.where(hi == h[:, None], lo, fill), fill, red)

        return self._emit_rows(
            cols, aux, mask,
            counts=mask.sum(dim=1, dtype=torch.int32),
            reduce_sum=lambda v, zero: v.sum(dim=1, dtype=v.dtype),
            reduce_extreme=reduce_extreme,
            reduce_extreme_pair=reduce_extreme_pair,
        )

    def _pack_rows(self, rows):
        """Logical rows -> one int32 [R, n] tensor for a single readback:
        f32 rows travel bit-cast (exact; _unpack_rows reverses it)."""
        import torch

        return torch.stack([
            r if r.dtype == torch.int32 else r.to(torch.float32).view(torch.int32)
            for r in rows
        ])

    def _unpack_rows(self, packed: np.ndarray) -> List[np.ndarray]:
        """Inverse of _pack_rows on the host: int rows as int64, float rows
        as f32."""
        return [
            packed[i].astype(np.int64) if is_int else packed[i].view(np.float32)
            for i, is_int in enumerate(self._int_rows)
        ]

    # ------------------------------------------------------------------
    def _group_codes(self, batch: pa.RecordBatch) -> Tuple[np.ndarray, List[pa.Array], int]:
        """Host side: evaluate group keys, rank to dense batch-local codes."""
        n = batch.num_rows
        if not self.group_exprs:
            return np.zeros(n, dtype=np.int32), [], 1
        key_arrays = []
        for e, _name in self.group_exprs:
            arr = e.evaluate(batch)
            if isinstance(arr, pa.ChunkedArray):
                arr = arr.combine_chunks()
            key_arrays.append(arr)
        encoded = []
        for arr in key_arrays:
            if isinstance(arr, pa.DictionaryArray):
                d = arr
            else:
                d = pc.dictionary_encode(arr)
            if d.indices.null_count:
                raise UnsupportedOnDevice("null group key")
            codes_i = d.indices.to_numpy(zero_copy_only=False).astype(np.int64)
            encoded.append((codes_i, d.dictionary))

        card = 1
        for _c, dv in encoded:
            card *= max(1, len(dv))

        if card <= 1024:
            # dense fast path: combined dictionary code IS the group id — no
            # np.unique pass; empty groups are dropped later (counts == 0)
            combined = np.zeros(n, dtype=np.int64)
            for codes_i, dv in encoded:
                combined = combined * max(1, len(dv)) + codes_i
            # decompose 0..card-1 into per-column dictionary values
            uniq_rows = []
            gids = np.arange(card, dtype=np.int64)
            rem = gids
            parts = []
            for codes_i, dv in reversed(encoded):
                size = max(1, len(dv))
                parts.append(rem % size)
                rem = rem // size
            for (codes_i, dv), pcodes in zip(encoded, reversed(parts)):
                uniq_rows.append(dv.take(pa.array(np.minimum(pcodes, max(0, len(dv) - 1)))))
            return combined.astype(np.int32), uniq_rows, card

        inv, first_idx, n_groups = dense_rank(
            [(codes_i, len(dv)) for codes_i, dv in encoded]
        )
        # key values for each distinct group = the first row bearing it
        take_idx = pa.array(first_idx.astype(np.int64))
        uniq_rows = [
            (arr.dictionary.take(arr.indices.take(take_idx))
             if isinstance(arr, pa.DictionaryArray) else arr.take(take_idx))
            for arr in key_arrays
        ]
        return inv.astype(np.int32), uniq_rows, n_groups

    # ------------------------------------------------------------------
    def _scan_batches(self, partition: int, ctx):
        """Read the scan partition for device consumption. Parquet fast path:
        eager read_table with dictionary columns (dictionary pages map
        straight to codes — ~10x faster than the streaming dictionary read).
        With scan_stride=N, driven partition p covers scan partitions
        p, p+N, p+2N, ... (N=1: SINGLE mode over MergeExec reads them all)."""
        if self.scan_stride is not None:
            total = self.scan.output_partitioning().partition_count()
            parts = range(partition, total, self.scan_stride)
        else:
            parts = [partition]
        if isinstance(self.scan, ParquetScanExec):
            from ballista_tpu_torch.ops.runtime import ordered_map

            def read_one(p: int) -> pa.Table:
                return self._read_scan_file(self.scan.source.files[p], ctx)

            # multi-file (scan_stride) reads are independent: decode up to
            # `workers` files concurrently, yielding tables in file order so
            # the batch stream is identical to the serial read
            for table in ordered_map(
                read_one, parts,
                ctx.config.tpu_ingest_workers(), ctx.config.tpu_ingest_depth(),
            ):
                yield from table.to_batches(max_chunksize=ctx.batch_size)
            return
        for p in parts:
            yield from self.scan.execute(p, ctx)

    def _read_scan_file(self, path: str, ctx) -> pa.Table:
        """Eager parquet read of one scan file (dictionary pages map straight
        to codes). Factored out of _scan_batches so the chunk-delta prepare
        reads per file — and so tests can interpose a mid-append mutation
        between the identity stat and the read (ISSUE 19 bugfix)."""
        import pyarrow.parquet as pq

        names = self.scan.schema().names
        strings = [
            f.name
            for f in self.scan.schema()
            if pa.types.is_string(f.type) or pa.types.is_large_string(f.type)
        ]
        return pq.read_table(
            path, columns=names, read_dictionary=strings
        ).combine_chunks()

    def _check_int_ranges(self, batch_cols, n: int) -> None:
        """Integer sums accumulate in int32 on device; decline when a masked
        sum over n rows could overflow (ADVICE r1: silent f32 rounding of
        integer aggregates). batch_cols: one Dict[int, np.ndarray], or a list
        of them when the sum spans several mesh shards (psum adds across
        shards, so the bound uses the GLOBAL row count)."""
        col_dicts = batch_cols if isinstance(batch_cols, list) else [batch_cols]
        for a, ie, ix in zip(self.aggs, self.agg_inputs, self.int_exact):
            if not ix or a.fn not in ("sum", "avg"):
                continue
            maxabs = 0
            for bc in col_dicts:
                npcol = bc.get(ie.index)
                if npcol is not None and len(npcol):
                    maxabs = max(
                        maxabs, abs(int(npcol.max())), abs(int(npcol.min()))
                    )
            if maxabs * n > _INT32_MAX:
                raise UnsupportedOnDevice(
                    f"int32 sum over column {ie.name!r} may overflow"
                )

    def _lower_columns(self, batch: pa.RecordBatch) -> Dict[int, np.ndarray]:
        cols: Dict[int, np.ndarray] = {}
        for idx, dtype in self.compiler.used_columns.items():
            d = self.dicts.dicts.get(idx)
            cols[idx] = column_to_numpy(batch.column(idx), dtype, d)
        for idx, width in self._bit_planes.items():
            cols.update(self._lower_planes(batch.column(idx), idx, width))
        return cols

    @staticmethod
    def _lower_planes(arr, idx: int, width: str) -> Dict[int, np.ndarray]:
        """Bijected min/max input: lower the RAW Arrow float column to its
        order-preserving int32 key plane(s) — never through the f32 device
        copy, which would round f64 values. Declines on NaN: Arrow's host
        min/max SKIPS NaN, and no single key order can make a value both
        never-min and never-max."""
        from ballista_tpu_torch.ops import floatbits

        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        if arr.null_count:
            raise UnsupportedOnDevice("null values in device column")
        vals = arr.to_numpy(zero_copy_only=False)
        if np.isnan(vals).any():
            raise UnsupportedOnDevice("NaN in float min/max column")
        hk, lk = plane_keys(idx)
        if width == "f32":
            return {hk: floatbits.f32_to_i32(vals.astype(np.float32, copy=False))}
        hi, lo = floatbits.i64_to_planes(floatbits.f64_to_i64(vals))
        return {hk: hi, lk: lo}

    # holds-lock: self._prepare_lock
    def _prepare_partition(self, partition: int, ctx) -> List[dict]:
        """Host work for one partition of the "batches" route: scan, rank
        group codes, lower, narrow, pad, upload. Returns per-batch device
        entries (the tensors stay resident in the stage's cache).

        Pipelined (ballista.tpu.ingest_workers > 0): parquet read +
        dictionary decode + group ranking run on a small thread pool, at
        most ingest_depth batches ahead of the in-order consume side
        (narrow/encode/upload), which must stay ordered: each batch's narrow
        choice feeds the next batch's prior, and dictionary codes grow in
        batch order."""
        import time as _time

        from ballista_tpu_torch.ops.runtime import pipelined_map, record_ingest

        dev = self.device
        t_wall0 = _time.perf_counter()
        scan_s = encode_s = upload_s = 0.0
        src_times: List[float] = []  # appended by the reader thread only
        entries: List[dict] = []
        # all of a partition's batch entries are live on the device at once
        # during run(); past the budget the stage declines to the host
        budget = ctx.config.tpu_hbm_budget()
        total_bytes = 0

        def _prefetch(batch: pa.RecordBatch):
            # group codes FIRST: a high-cardinality switch must not pay the
            # column upload
            t0 = _time.perf_counter()
            codes, key_values, n_groups = self._group_codes(batch)
            return batch, codes, key_values, n_groups, _time.perf_counter() - t0

        batch_src = (
            b for b in self._scan_batches(partition, ctx) if b.num_rows
        )
        for batch, codes, key_values, n_groups, dt in pipelined_map(
            batch_src, _prefetch,
            ctx.config.tpu_ingest_workers(), ctx.config.tpu_ingest_depth(),
            on_src_time=src_times.append,
        ):
            scan_s += dt
            n = batch.num_rows
            bucket = bucket_rows(n)
            if n_groups == 0:
                continue
            if n_groups > MAX_GROUPS:
                raise TooManyGroups(f"{n_groups} groups exceeds the batches route")
            t_enc0 = _time.perf_counter()
            npcols = self._lower_columns(batch)
            self._check_int_ranges(npcols, n)
            staged: Dict[int, tuple] = {}
            for idx in list(npcols):
                npcol = npcols.pop(idx)
                fill = False if npcol.dtype == np.bool_ else 0
                narrow, lut, choice = narrow_column(
                    npcol, self._narrow_choice.get(idx)
                )
                del npcol
                padded = pad_to(narrow, bucket, fill)
                staged[idx] = (padded, lut, choice)
                total_bytes += padded.nbytes + (0 if lut is None else lut.nbytes)
            total_bytes += 3 * bucket  # int16 codes + bool row_valid
            check_budget(total_bytes, budget, "stage batches")
            seg_bucket = bucket_rows(n_groups, 16) + 1  # +1 dump slot
            # group codes fit int16 by construction (n_groups <= MAX_GROUPS)
            codes_pad = pad_to(codes.astype(np.int16), bucket, 0)
            row_valid = np.zeros(bucket, dtype=np.bool_)
            row_valid[:n] = True
            encode_s += _time.perf_counter() - t_enc0
            t_up0 = _time.perf_counter()
            cols: Dict = {}
            for idx, (arr, lut, choice) in staged.items():
                self._narrow_choice[idx] = choice
                col = upload(arr, dev)
                cols[idx] = col if lut is None else (col, upload(lut, dev))
            entries.append(
                {
                    "n_groups": int(n_groups),
                    "seg_bucket": int(seg_bucket),
                    "cols": cols,
                    "codes": upload(codes_pad, dev),
                    "row_valid": upload(row_valid, dev),
                    "key_values": key_values,
                }
            )
            upload_s += _time.perf_counter() - t_up0
        scan_s += sum(src_times)
        record_ingest(scan_s, encode_s, upload_s, _time.perf_counter() - t_wall0)
        return entries

    def _sorted_kernel_eligible(self, ctx) -> bool:
        """The "pallas_sorted" route's static gate (the JAX package's,
        kept): the kernel sums f32 rows, so it takes sum/count/avg stages
        without exact-int inputs, and only under sorted_kernel=pallas."""
        return (
            ctx.config.tpu_sorted_kernel() == "pallas"
            and all(a.fn in ("sum", "count", "avg") for a in self.aggs)
            and not any(self.int_exact)
            and self.topk is None
        )

    # holds-lock: self._prepare_lock
    def _prepare_partition_sorted(self, partition: int, ctx) -> dict:
        """High-cardinality prepare: the whole partition ranked by group.
        Under sorted_kernel=pallas, eligible stages of at most 2^24 rows
        sort flat for the sorted_grouped_sum kernel; every other stage takes
        the chunked-segment layout (ops/layout.py), materialized on the host
        and uploaded as [V, L1] tiles."""
        import time as _time

        from ballista_tpu_torch.ops.layout import SortedSegmentLayout
        from ballista_tpu_torch.ops.runtime import record_ingest, record_routing_event

        t_wall0 = _time.perf_counter()
        batches = [b for b in self._scan_batches(partition, ctx) if b.num_rows]
        if not batches:
            return {"kind": "empty"}
        table = pa.Table.from_batches(batches).combine_chunks()
        batch = table.to_batches(max_chunksize=table.num_rows)[0]
        del batches, table
        codes, key_values, n_groups = self._group_codes(batch)
        scan_s = _time.perf_counter() - t_wall0
        if n_groups == 0:
            return {"kind": "empty"}
        if self._sorted_kernel_eligible(ctx) and batch.num_rows <= SORTED_KERNEL_MAX_ROWS:
            out = self._prepare_pallas_sorted(batch, codes, key_values, n_groups, ctx)
            t_end = _time.perf_counter()
            # sort, lower and upload are one step here: counted as encode
            record_ingest(scan_s, t_end - t_wall0 - scan_s, 0.0, t_end - t_wall0)
            return out
        layout = None
        if self.topk is not None:
            # fused top-k wants the one-chunk-per-group cover: the chunk
            # fold becomes identity, so the gathered k columns are the
            # values the full readback would emit. The int range check runs
            # against the cover width (a whole-group sum in one chunk);
            # failing either check falls back to the default chunking, and
            # fusion for the partition degrades to the fold variant or the
            # full readback.
            npcols = self._lower_columns(batch)
            cover_L1 = _topk_cover_L1(codes, n_groups)
            if cover_L1 is not None:
                try:
                    self._check_int_ranges(npcols, cover_L1)
                    layout = SortedSegmentLayout(codes, n_groups, force_L1=cover_L1)
                except UnsupportedOnDevice:
                    layout = None
            elif ctx.config.tpu_cost_model():
                # the cover failed because a few dominant groups blow its
                # bounds: split THEM to the epilogue's segment fold and keep
                # every tail group on one chunk, counted as a re-plan
                skew = skew_split_plan(codes, n_groups)
                if skew is not None:
                    try:
                        self._check_int_ranges(npcols, skew[0])
                        layout = SortedSegmentLayout(codes, n_groups, force_L1=skew[0])
                        record_routing_event("skew_replan")
                    except UnsupportedOnDevice:
                        layout = None
            if layout is None:
                layout = SortedSegmentLayout(codes, n_groups)
                self._check_int_ranges(npcols, layout.L1)
        else:
            # layout first, codes freed, then lower: the host-memory peak
            # holds the take-index or the row-space columns, not both
            layout = SortedSegmentLayout(codes, n_groups)
            del codes
            npcols = self._lower_columns(batch)
            self._check_int_ranges(npcols, layout.L1)
        del batch
        # narrow and materialize one column at a time: the peak holds one
        # column in row space beside the tiles
        staged: Dict[int, tuple] = {}
        total = layout.clen.nbytes
        for idx in list(npcols):
            npcol = npcols.pop(idx)
            narrow, lut, choice = narrow_column(npcol, self._narrow_choice.get(idx))
            del npcol
            tiles = layout.materialize(narrow)
            del narrow
            staged[idx] = (tiles, lut, choice)
            total += tiles.nbytes + (0 if lut is None else lut.nbytes)
        # the take-index served every materialize
        layout.row_take = None
        t_up0 = _time.perf_counter()
        out = self._finish_sorted(ctx, layout, staged, key_values, total)
        t_end = _time.perf_counter()
        record_ingest(scan_s, t_up0 - t_wall0 - scan_s, t_end - t_up0, t_end - t_wall0)
        return out

    def _finish_sorted(self, ctx, layout, staged: Dict, key_values, total: int) -> dict:
        """Budget check, then the h2d upload of the staged tiles (recording
        each column's narrow choice) and the "sorted" entry."""
        check_budget(total, ctx.config.tpu_hbm_budget(), "stage tiles")
        dev = self.device
        cols: Dict = {}
        for idx in list(staged):
            tiles, lut, choice = staged.pop(idx)
            self._narrow_choice[idx] = choice
            col = upload(tiles, dev)
            cols[idx] = col if lut is None else (col, upload(lut, dev))
        return {
            "kind": "sorted",
            "layout": layout,
            "cols": cols,
            "clen": upload(layout.clen, dev),
            "key_values": key_values,
            "n_groups": layout.n_groups,
        }

    def _prepare_pallas_sorted(self, batch, codes, key_values, n_groups, ctx) -> dict:
        """Flat sorted residency for the sorted_grouped_sum kernel: rows in
        stable group-rank order, full-width columns (not narrowed), no
        block padding (the kernel masks its ragged edge)."""
        dev = self.device
        order = np.argsort(codes, kind="stable")
        n = len(order)
        codes_sorted = codes[order].astype(np.int32)
        npcols = self._lower_columns(batch)
        total = n * (4 + 1)  # codes int32 + row_valid bool
        for npcol in npcols.values():
            total += n * npcol.dtype.itemsize
        check_budget(total, ctx.config.tpu_hbm_budget(), "sorted kernel stage columns")
        cols: Dict[int, object] = {
            idx: upload(npcol[order], dev) for idx, npcol in npcols.items()
        }
        return {
            "kind": "pallas_sorted",
            "codes": upload(codes_sorted, dev),
            "cols": cols,
            "row_valid": upload(np.ones(n, dtype=np.bool_), dev),
            "key_values": key_values,
            "n_groups": n_groups,
        }

    def _masked_rows(self, cols, aux, row_valid):
        """[1 + A, N] f32 rows for sorted_grouped_sum (the JAX package's
        _pallas_masked_rows_step): the filter mask (its group sums are the
        counts), then each sum/avg input times the mask."""
        import torch

        cols = widen_cols(cols)
        mask = row_valid
        for fm in self.filter_masks:
            mask = torch.logical_and(mask, fm(cols, aux))
        maskf = mask.to(torch.float32)
        rows = [maskf]
        for vf in self.value_fns:
            if vf is None:
                continue
            rows.append(_rows_like(vf.fn(cols, aux), mask).to(torch.float32) * maskf)
        return torch.stack(rows)

    def _run_pallas_sorted(self, ent: dict, aux) -> pa.Table:
        from ballista_tpu_torch.ops.cuda_kernels import sorted_grouped_sum

        vals = self._masked_rows(ent["cols"], aux, ent["row_valid"])
        # counts travel as f32 rows and widen to f64 here: exact below 2^24
        out = readback(
            sorted_grouped_sum(ent["codes"], vals, ent["n_groups"])
        ).astype(np.float64)
        counts = out[0]
        outputs: List[np.ndarray] = []
        vi = 1
        for a in self.aggs:
            if a.fn == "count":
                outputs.append(counts)
                continue
            outputs.append(out[vi])
            vi += 1
            if a.fn == "avg":
                outputs.append(counts)
        return self._assemble_partial(
            outputs, counts, ent["key_values"], ent["n_groups"]
        )

    # ------------------------------------------------------------------
    def run(self, partition: int, ctx) -> pa.Table:
        from ballista_tpu_torch.ops.runtime import (
            entry_device_bytes,
            reserve_and_pin,
        )

        if ctx.device is None:
            raise RuntimeError(
                "device stage run without a device: the TaskContext of the "
                "cuda backend must name its torch.device"
            )
        with self._prepare_lock:
            if self.device is None:
                self.device = ctx.device
        if self.device != ctx.device:
            raise RuntimeError(
                f"stage prepared on {self.device} was run on {ctx.device}"
            )
        use_cache = ctx.config.device_cache() and self.cacheable
        if not self.cacheable and not ctx.config.tpu_fuse_volatile():
            # aggregating over a re-executed source (e.g. a host join) pays
            # encode+transfer per query with no residency payoff: opt-in
            raise UnsupportedOnDevice(
                "volatile row source (enable ballista.tpu.fuse_volatile_sources)"
            )
        prepared = self._device_cache.get(partition) if use_cache else None
        if prepared is None:
            with self._prepare_lock:
                prepared = self._device_cache.get(partition) if use_cache else None
                if prepared is None:
                    if self.topk is not None:
                        # the fused top-k epilogue needs ONE device step over
                        # the whole partition (per-batch group codes are
                        # batch-local); the sorted prepare decides per
                        # partition whether fusion can be live
                        prepared = self._prepare_partition_sorted(partition, ctx)
                    else:
                        try:
                            prepared = {"kind": "batches",
                                        "entries": self._prepare_partition(partition, ctx)}
                        except TooManyGroups:
                            prepared = self._prepare_partition_sorted(partition, ctx)
                    if use_cache:
                        # pin within the budget; past it the partition
                        # streams per query
                        reserve_and_pin(
                            self, partition, prepared, self._device_cache,
                            entry_device_bytes(prepared),
                            ctx.config.tpu_hbm_budget(),
                        )
        return self.execute_prepared(prepared, self.device)

    def execute_prepared(self, prepared: dict, device) -> pa.Table:
        """Run the device step over one prepared partition entry (what
        _prepare_partition / _prepare_partition_sorted build, or what
        ops/state.py::prepared_from_reference makes of a JAX stage's entry)
        and assemble its partial-state table."""
        record_route(prepared["kind"])
        if prepared["kind"] == "empty":
            return self.partial_schema.empty_table()
        aux = [upload(np.asarray(a), device) for a in self.compiler.build_aux()]
        if prepared["kind"] == "sorted":
            if self._topk_eligible(prepared):
                out = self._run_topk(prepared, aux)
                if out is not None:
                    return out  # None: boundary tie -> full readback below
            return self._run_sorted(prepared, aux)
        if prepared["kind"] == "pallas_sorted":
            return self._run_pallas_sorted(prepared, aux)
        if prepared["kind"] != "batches":
            raise ValueError(f"unknown prepared entry kind {prepared['kind']!r}")
        return self._run_batches(prepared["entries"], aux)

    def _run_batches(self, entries: List[dict], aux) -> pa.Table:
        """Enqueue every batch's step, then read all int32 rows back in one
        transfer and all f32 rows in another."""
        import torch

        steps = [
            self._batch_step(
                ent["seg_bucket"], ent["cols"], aux, ent["codes"], ent["row_valid"]
            )
            for ent in entries
        ]
        if not steps:
            return self.partial_schema.empty_table()
        groups = sum(ent["seg_bucket"] for ent in entries)
        ints = readback(torch.cat([i.reshape(-1) for i, _ in steps]), rows=groups)
        floats = None
        if steps[0][1] is not None:
            floats = readback(
                torch.cat([f.reshape(-1) for _, f in steps]), rows=groups
            )
        n_int = steps[0][0].shape[0]
        n_float = 0 if floats is None else steps[0][1].shape[0]
        partial_tables: List[pa.Table] = []
        io = fo = 0
        for ent in entries:
            G = ent["seg_bucket"]
            int_rows = ints[io:io + n_int * G].reshape(n_int, G).astype(np.int64)
            io += n_int * G
            float_rows = None
            if floats is not None:
                float_rows = floats[fo:fo + n_float * G].reshape(n_float, G)
                fo += n_float * G
            rows: List[np.ndarray] = []
            ii = fi = 0
            for is_int in self._int_rows:
                if is_int:
                    rows.append(int_rows[ii])
                    ii += 1
                else:
                    rows.append(float_rows[fi])
                    fi += 1
            n_groups = ent["n_groups"]
            counts_np = rows[0][:n_groups]
            outputs = [o[:n_groups] for o in self._state_outputs(rows)]
            t = self._assemble_partial(outputs, counts_np, ent["key_values"], n_groups)
            if t.num_rows:
                partial_tables.append(t)
        if not partial_tables:
            return self.partial_schema.empty_table()
        return pa.concat_tables(partial_tables)

    def _state_outputs(self, rows: List[np.ndarray]) -> List[np.ndarray]:
        """Decoded logical rows -> one output column per partial-state
        FIELD (spec-driven; bijected min/max states invert through
        ops/floatbits.py, f64 pairs recombining their planes first). Empty
        groups still carry sentinel fills here — every caller masks them
        with counts==0 before assembly."""
        from ballista_tpu_torch.ops import floatbits

        outs: List[np.ndarray] = []
        for row, kind, _fold in self._state_specs:
            if kind == "f64bits":
                outs.append(
                    floatbits.i64_to_f64(
                        floatbits.planes_to_i64(rows[row], rows[row + 1])
                    )
                )
            elif kind == "f32bits":
                outs.append(
                    floatbits.i32_to_f32(rows[row].astype(np.int32)).astype(
                        np.float64
                    )
                )
            else:
                outs.append(rows[row])
        return outs

    def _fold_state_rows(self, layout, rows: List[np.ndarray]) -> List[np.ndarray]:
        """Fold decoded per-chunk partial rows to per-group state columns.
        f64-bijected pairs recombine into int64 keys BEFORE the fold —
        lexicographic (hi, lo) min/max IS int64 key min/max, and reduceat
        over int keys is exact — then invert to the bit-exact float."""
        from ballista_tpu_torch.ops import floatbits

        folds = {"sum": layout.fold_sum, "min": layout.fold_min,
                 "max": layout.fold_max}
        outs: List[np.ndarray] = []
        for row, kind, fold in self._state_specs:
            if kind == "f64bits":
                keys = floatbits.planes_to_i64(rows[row], rows[row + 1])
                outs.append(floatbits.i64_to_f64(folds[fold](keys)))
            elif kind == "f32bits":
                k32 = folds[fold](rows[row]).astype(np.int32)
                outs.append(floatbits.i32_to_f32(k32).astype(np.float64))
            else:
                outs.append(folds[fold](rows[row]))
        return outs

    def _run_sorted(self, ent: dict, aux) -> pa.Table:
        """Full readback of the chunk partials ([R, V] in one transfer),
        folded to groups on the host."""
        layout = ent["layout"]
        rows = self._unpack_rows(readback(self._pack_rows(
            self._sorted_step(layout.L1, ent["cols"], aux, ent["clen"])
        )))
        counts = layout.fold_sum(rows[0])
        outputs = self._fold_state_rows(layout, rows)
        return self._assemble_partial(
            outputs, counts, ent["key_values"], ent["n_groups"]
        )

    # -- fused Sort+Limit epilogue (planner _topk_pushdown) -------------
    def _topk_eligible(self, ent: dict) -> bool:
        """Fusion is live for a partition when the selection can actually
        exclude groups AND the device can produce exact per-group states:
        either the layout carries the one-chunk cover (chunk partials ARE
        the group states) or the fold variant runs (chunk -> group segment
        fold on the device for skewed layouts). The fold variant sums int32
        on the device where the host fold widens to int64, so int-exact SUM
        aggregates disable it: the full readback runs instead, same entry,
        same values."""
        if (
            self.topk is None
            or ent.get("layout") is None
            or ent["n_groups"] <= self.topk["k"]
        ):
            return False
        if ent["layout"].one_chunk_per_group:
            return True
        return not any(
            ix and a.fn in ("sum", "avg")
            for a, ix in zip(self.aggs, self.int_exact)
        )

    def _topk_select(self, counts, row_of, packed):
        """Device Sort+Limit over per-group states (the shared tail of the
        JAX package's _topk_core): lower every sort key to int32 lanes
        whose signed order equals the key order (exact int states as-is,
        f32 scores through the floatbits bijection, f64-bijected states as
        their hi/lo plane pair; bitwise NOT flips a descending key without
        overflow), rank (validity, key lanes..., group index)
        lexicographically and gather the k best columns of `packed`
        ([R, G] int32, _pack_rows). Appends, as rows of length k, each
        lane's k-th and (k+1)-th sorted values (the boundary-tie probe) and
        the selected group indices."""
        import torch

        from ballista_tpu_torch.ops.floatbits import torch_f32_to_i32

        k = self.topk["k"]
        # validity leads: empty groups (dropped by the unfused assembly)
        # must never displace a real group
        lanes = [torch.where(counts > 0, 0, 1).to(torch.int32)]
        for row, kind, desc in self.topk["keys"]:
            if kind == "num":
                kv = [torch_f32_to_i32(row_of(row))]
            elif kind == "f64bits":
                kv = [row_of(row), row_of(row + 1)]
            else:  # "int" / "f32bits": exact int32 state
                kv = [row_of(row)]
            lanes.extend(~v if desc else v for v in kv)
        # a lexicographic sort as a chain of stable sorts from the last lane
        # to the first; the identity start order is the trailing
        # group-index lane, so ties resolve to the lowest group
        order = torch.arange(counts.shape[0], device=counts.device)
        for lane in reversed(lanes):
            order = order[torch.sort(lane[order], stable=True).indices]
        sel = order[:k]
        probe = torch.stack([lane[order[k - 1:k + 1]] for lane in lanes])
        return torch.cat([
            packed[:, sel],
            probe.reshape(-1, 1).expand(-1, k),
            sel.to(torch.int32)[None, :],
        ])

    def _topk_step(self, ent: dict, aux):
        """The JAX package's _topk_core. One-chunk cover: chunk partials
        are the group states. Otherwise (skewed cover) chunk partials
        segment-fold to group states on the device first — sum/min/max per
        _state_specs; f64-bijected pairs fold lexicographically, lo
        competing only among chunks that hold the group's hi extreme.
        min/max folds are exact; f32 sums regroup (the documented device
        tolerance); int-exact sums never take this variant
        (_topk_eligible)."""
        import torch

        layout = ent["layout"]
        rows = self._sorted_step(layout.L1, ent["cols"], aux, ent["clen"])
        if layout.one_chunk_per_group:
            return self._topk_select(rows[0], lambda r: rows[r], self._pack_rows(rows))
        owner = ent.get("owner_dev")
        if owner is None:
            owner = ent["owner_dev"] = upload(
                layout.owner.astype(np.int64), ent["clen"].device
            )
        G = ent["n_groups"]
        ops = {"sum": "sum", "min": "amin", "max": "amax"}

        def red(fop, v):
            # every group owns >= 1 chunk, so include_self=False leaves no
            # group at its initial value
            return torch.zeros(G, dtype=v.dtype, device=v.device).scatter_reduce_(
                0, owner, v, ops[fop], include_self=False
            )

        logical = {0: red("sum", rows[0])}  # counts
        for row, kind, fop in self._state_specs:
            if kind == "f64bits":
                hi, lo = rows[row], rows[row + 1]
                h = red(fop, hi)
                fill = _INT32_MAX if fop == "min" else -_INT32_MAX - 1
                logical[row] = h
                logical[row + 1] = red(fop, torch.where(hi == h[owner], lo, fill))
            else:
                logical[row] = red(fop, rows[row])
        return self._topk_select(
            logical[0], lambda r: logical[r],
            self._pack_rows([logical[r] for r in range(len(self._int_rows))]),
        )

    def _run_topk(self, ent: dict, aux) -> Optional[pa.Table]:
        """Fused-epilogue readback: k columns plus the boundary probe, in
        one transfer. Returns None (the caller falls back to the full
        readback, same entry, same values) when un-fused trailing sort keys
        exist AND the k-th and (k+1)-th groups tie on every fused lane —
        the only case where the device selection could exclude a group the
        host order admits."""
        spec = self.topk
        packed = readback(self._topk_step(ent, aux))
        n_rows = len(self._int_rows)
        nl = 1 + spec["n_lanes"]
        probe = packed[n_rows:n_rows + 2 * nl, 0].reshape(nl, 2)
        if (not spec["covered"] and (probe[:, 0] == probe[:, 1]).all()
                and probe[0, 0] == 0):
            return None  # boundary tie under un-fused tie-breakers
        idx = packed[-1].astype(np.int64)
        order = np.argsort(idx, kind="stable")
        idx = idx[order]
        rows = [r[order] for r in self._unpack_rows(packed[:n_rows])]
        take = pa.array(idx)
        key_values = [
            (kv if isinstance(kv, (pa.Array, pa.ChunkedArray)) else pa.array(kv)).take(take)
            for kv in ent["key_values"]
        ]
        return self._assemble_partial(
            self._state_outputs(rows), rows[0], key_values, len(idx)
        )

    def _assemble_partial(
        self,
        outputs: List[np.ndarray],
        counts: np.ndarray,
        key_values: List[pa.Array],
        n_groups: int,
    ) -> pa.Table:
        """Build a partial-state Arrow table for one batch's groups."""
        arrays: List[pa.Array] = []
        fields = list(self.partial_schema)
        # group key columns
        if self.group_exprs:
            for kv, f in zip(key_values, fields[: len(key_values)]):
                arr = kv if isinstance(kv, pa.Array) else pa.array(kv)
                if arr.type != f.type:
                    arr = pc.cast(arr, f.type)
                arrays.append(arr)
        # aggregate state columns
        oi = 0
        col_pos = len(key_values)
        nonempty = counts > 0
        for a in self.aggs:
            for _f in a.state_fields():
                f = fields[col_pos]
                raw = outputs[oi]
                # groups with no surviving rows carry sentinel fills in
                # min/max rows; null them out so the merge ignores them
                arrays.append(state_column(a, raw, f.type, ~nonempty))
                oi += 1
                col_pos += 1
        # drop groups where every row was filtered out (counts == 0) to match
        # host-partial semantics (those groups never appear)
        t = pa.table(arrays, schema=self.partial_schema)
        if not nonempty.all():
            t = t.filter(pa.array(nonempty))
        return t
