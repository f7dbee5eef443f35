"""Window function execution.

WindowExec computes row_number / rank / dense_rank and the five aggregates
with SQL frame semantics: whole-partition when no ORDER BY is given, the
standard peer-inclusive running frame (RANGE UNBOUNDED PRECEDING..CURRENT
ROW) with ORDER BY, and explicit ROWS BETWEEN frames. Strategy: merge to
one partition, sort by (partition keys, order keys), compute partition/peer
boundaries once, then every function is a vectorized pass — cumcounts for
ranking, prefix sums / accumulates (plus padded sliding windows for bounded
min/max) for aggregates. Output rows come back in sorted order (row order
is unspecified unless the query adds ORDER BY).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from ballista_tpu_torch.errors import PlanError
from ballista_tpu_torch.physical.expr import PhysicalExpr, _as_array
from ballista_tpu_torch.physical.plan import (
    ExecutionPlan,
    Partitioning,
    TaskContext,
    batch_table,
    collect_partition,
)


class WindowFuncDesc:
    def __init__(
        self,
        fn: str,
        arg: Optional[PhysicalExpr],
        partition_by: List[PhysicalExpr],
        order_by: List[Tuple[PhysicalExpr, bool]],  # (expr, ascending)
        name: str,
        dtype: pa.DataType,
        frame: Optional[Tuple[str, Optional[float], Optional[float]]] = None,
    ) -> None:
        self.fn = fn
        self.arg = arg
        self.partition_by = partition_by
        self.order_by = order_by
        self.name = name
        self.dtype = dtype
        # (mode, start, end) frame; None side = unbounded; the whole value
        # None = SQL default (resolved at execution)
        self.frame = frame


def _codes(arr: pa.Array) -> np.ndarray:
    d = pc.dictionary_encode(arr)
    if isinstance(d, pa.ChunkedArray):
        d = d.combine_chunks()
    out = d.indices.to_numpy(zero_copy_only=False).astype(np.int64)
    return out


class WindowExec(ExecutionPlan):
    def __init__(self, input: ExecutionPlan, funcs: List[WindowFuncDesc]) -> None:
        self.input = input
        self.funcs = funcs
        fields = list(input.schema())
        fields += [pa.field(f.name, f.dtype) for f in funcs]
        self._schema = pa.schema(fields)

    def schema(self) -> pa.Schema:
        return self._schema

    def output_partitioning(self) -> Partitioning:
        return Partitioning.unknown(1)

    def children(self) -> List[ExecutionPlan]:
        return [self.input]

    def with_children(self, children: List[ExecutionPlan]) -> "WindowExec":
        return WindowExec(children[0], self.funcs)

    def execute(self, partition: int, ctx: TaskContext):
        assert partition == 0
        table = collect_partition(self.input, 0, ctx)
        if table.num_rows == 0:
            yield from self._schema.empty_table().to_batches()
            return
        batch = table.combine_chunks().to_batches()[0]
        n = batch.num_rows
        out_cols = list(table.combine_chunks().columns)
        for f in self.funcs:
            out_cols.append(self._compute(f, batch, n))
        yield from batch_table(
            pa.table(out_cols, schema=self._schema), ctx.batch_size
        )

    # ------------------------------------------------------------------
    def _compute(self, f: WindowFuncDesc, batch: pa.RecordBatch, n: int) -> pa.Array:
        # sort order: partition keys then order keys
        sort_cols = {}
        sort_keys = []
        for i, e in enumerate(f.partition_by):
            cn = f"__p{i}"
            sort_cols[cn] = _as_array(e.evaluate(batch), n)
            sort_keys.append((cn, "ascending"))
        for i, (e, asc) in enumerate(f.order_by):
            cn = f"__o{i}"
            sort_cols[cn] = _as_array(e.evaluate(batch), n)
            sort_keys.append((cn, "ascending" if asc else "descending"))
        if sort_cols:
            key_table = pa.table(sort_cols)
            order = pc.sort_indices(key_table, sort_keys=sort_keys).to_numpy()
        else:
            order = np.arange(n, dtype=np.int64)
        inv = np.empty(n, dtype=np.int64)
        inv[order] = np.arange(n, dtype=np.int64)

        # partition ids in sorted order
        if f.partition_by:
            pcodes = np.zeros(n, dtype=np.int64)
            for i in range(len(f.partition_by)):
                c = _codes(sort_cols[f"__p{i}"])[order]
                pcodes = pcodes * (int(c.max()) + 1 if len(c) else 1) + c
            new_part = np.empty(n, dtype=bool)
            new_part[0] = True
            new_part[1:] = pcodes[1:] != pcodes[:-1]
        else:
            new_part = np.zeros(n, dtype=bool)
            new_part[0] = True
        part_id = np.cumsum(new_part) - 1
        part_start = np.maximum.accumulate(np.where(new_part, np.arange(n), 0))

        if f.fn == "row_number":
            vals = np.arange(n) - part_start + 1
            return pa.array(vals[inv], type=pa.int64())
        if f.fn in ("rank", "dense_rank"):
            # order-key change detection within a partition
            changed = np.ones(n, dtype=bool)
            if f.order_by:
                ocodes = np.zeros(n, dtype=np.int64)
                for i in range(len(f.order_by)):
                    c = _codes(sort_cols[f"__o{i}"])[order]
                    ocodes = ocodes * (int(c.max()) + 1 if len(c) else 1) + c
                changed[1:] = (ocodes[1:] != ocodes[:-1]) | new_part[1:]
            if f.fn == "rank":
                change_pos = np.maximum.accumulate(np.where(changed, np.arange(n), 0))
                vals = change_pos - part_start + 1
            else:
                dense = np.cumsum(changed)
                base = np.maximum.accumulate(np.where(new_part, dense, 0))
                vals = dense - base + 1
            return pa.array(vals[inv], type=pa.int64())

        # aggregates: whole-partition (no ORDER BY), the standard
        # peer-inclusive running frame (ORDER BY, no explicit frame — RANGE
        # UNBOUNDED PRECEDING..CURRENT ROW), or an explicit ROWS frame.
        assert f.arg is not None or f.fn == "count"
        if f.arg is not None:
            argv = _as_array(f.arg.evaluate(batch), n)
            av = argv.to_numpy(zero_copy_only=False).astype(np.float64)[order]
            valid = pc.is_valid(argv).to_numpy(zero_copy_only=False)[order]
        else:
            av = np.ones(n, dtype=np.float64)
            valid = np.ones(n, dtype=bool)
        starts_idx = np.flatnonzero(new_part)
        seg_ends = np.append(starts_idx[1:], n)
        explicit = None  # per-row [lo, hi) bounds, when not a plain ROWS frame
        running = False  # explicit bounds with lo == partition start
        frame = f.frame
        if frame is None:
            if f.order_by:
                # RANGE default: rows tied on the order keys are peers and
                # every peer sees the same (full peer-run) value
                frame = ("rows", None, 0)
                ocodes = np.zeros(n, dtype=np.int64)
                for i in range(len(f.order_by)):
                    c = _codes(sort_cols[f"__o{i}"])[order]
                    ocodes = ocodes * (int(c.max()) + 1 if len(c) else 1) + c
                changed = np.ones(n, dtype=bool)
                changed[1:] = (ocodes[1:] != ocodes[:-1]) | new_part[1:]
                run_starts = np.flatnonzero(changed)
                nxt = np.append(run_starts[1:], n)
                explicit = (part_start, nxt[np.cumsum(changed) - 1])
                running = True
            else:
                frame = ("rows", None, None)
        mode, fstart, fend = frame
        if mode == "range" and explicit is None:
            # bounds via value search on the (sorted) single order key;
            # PRECEDING/FOLLOWING track the ordering direction
            karr = sort_cols["__o0"]
            if not (
                pa.types.is_integer(karr.type)
                or pa.types.is_floating(karr.type)
                or pa.types.is_decimal(karr.type)
            ):
                raise PlanError(
                    f"RANGE frames require a numeric ORDER BY key, got {karr.type}"
                )
            kv = karr.to_numpy(zero_copy_only=False).astype(np.float64)[order]
            running = fstart is None
            asc = f.order_by[0][1]
            sign = 1.0 if asc else -1.0
            kvs = kv * sign  # ascending view of the ordering
            lo = np.empty(n, dtype=np.int64)
            hi = np.empty(n, dtype=np.int64)
            for s0, e0 in zip(starts_idx, seg_ends):
                seg = kvs[s0:e0]
                # NULL order keys (NaN here) sort to the end of each
                # partition (sort_indices null_placement at_end) and form
                # one trailing peer group: offset bounds resolve to the
                # peer run itself, UNBOUNDED bounds keep the partition edge
                nan = np.isnan(seg)
                nn = int((~nan).sum())
                if nan[:nn].any():
                    raise PlanError(
                        "RANGE frames: non-contiguous null order keys"
                    )
                sub = seg[:nn]
                lo[s0:s0 + nn] = (
                    s0
                    if fstart is None
                    else s0 + np.searchsorted(sub, sub + fstart, side="left")
                )
                hi[s0:s0 + nn] = (
                    e0
                    if fend is None
                    else s0 + np.searchsorted(sub, sub + fend, side="right")
                )
                if nn < e0 - s0:
                    lo[s0 + nn:e0] = s0 if fstart is None else s0 + nn
                    hi[s0 + nn:e0] = e0
            explicit = (lo, hi)
        nparts = int(part_id[-1]) + 1
        if (fstart, fend) == (None, None) and explicit is None:
            cnt = np.zeros(nparts)
            np.add.at(cnt, part_id, valid.astype(np.float64))
            if f.fn == "count":
                vals = cnt[part_id][inv]
                return pc.cast(pa.array(vals), f.dtype)
            if f.fn in ("sum", "avg"):
                agg = np.zeros(nparts)
                np.add.at(agg, part_id, np.where(valid, av, 0.0))
                if f.fn == "avg":
                    agg = agg / np.maximum(cnt, 1)
            elif f.fn == "min":
                agg = np.full(nparts, np.inf)
                np.minimum.at(agg, part_id, np.where(valid, av, np.inf))
            elif f.fn == "max":
                agg = np.full(nparts, -np.inf)
                np.maximum.at(agg, part_id, np.where(valid, av, -np.inf))
            else:
                raise PlanError(f"unsupported window function {f.fn}")
            vals = agg[part_id][inv]
            # a partition with no valid input rows aggregates to NULL
            empty = (cnt == 0)[part_id][inv]
            return pc.cast(pa.array(vals, mask=empty), f.dtype)
        vals, null_mask = _framed_aggregate(
            f.fn, av, valid, part_start, part_id, new_part,
            (fstart, fend), explicit, running,
        )
        arr = pa.array(vals[inv], mask=null_mask[inv] if null_mask is not None else None)
        return pc.cast(arr, f.dtype)

    def fmt(self) -> str:
        return "WindowExec: " + ", ".join(
            f"{f.fn}(...) AS {f.name}" for f in self.funcs
        )


def _framed_aggregate(
    fn: str,
    av: np.ndarray,
    valid: np.ndarray,
    part_start: np.ndarray,
    part_id: np.ndarray,
    new_part: np.ndarray,
    frame,
    explicit: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    running: bool = False,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Framed aggregates over rows already sorted by (partition keys, order
    keys). Per row i the window is rows [i+start, i+end] clamped to its
    partition — or, when `explicit` carries per-row [lo, hi) bounds (the
    peer-inclusive running default, RANGE frames), exactly those rows.
    sum/count/avg vectorize via prefix sums (windows never cross partition
    bounds, so one global prefix array suffices); min/max run per partition
    with accumulate / padded sliding windows (ROWS) or a sparse table
    (explicit bounds). Returns (values, null mask for empty windows)."""
    n = len(av)
    start, end = frame
    # per-row partition bounds [ps, pe)
    starts_idx = np.flatnonzero(new_part)
    ends = np.append(starts_idx[1:], n)
    ps = part_start
    pe = ends[part_id]
    idx = np.arange(n)
    if explicit is not None:
        lo, hi = explicit
        hi = np.maximum(hi, lo)
    else:
        lo = ps if start is None else np.clip(idx + start, ps, pe)
        hi = pe if end is None else np.clip(idx + end + 1, ps, pe)
        hi = np.maximum(hi, lo)  # empty window

    if fn in ("sum", "avg", "count"):
        pref = np.concatenate([[0.0], np.cumsum(np.where(valid, av, 0.0))])
        prefc = np.concatenate([[0.0], np.cumsum(valid.astype(np.float64))])
        s = pref[hi] - pref[lo]
        c = prefc[hi] - prefc[lo]
        if fn == "count":
            return c, None
        if fn == "avg":
            return s / np.maximum(c, 1), (c == 0)
        return s, (c == 0)

    if fn not in ("min", "max"):
        raise PlanError(f"unsupported framed window function {fn}")
    fill = np.inf if fn == "min" else -np.inf
    acc = np.minimum.accumulate if fn == "min" else np.maximum.accumulate
    red = np.minimum if fn == "min" else np.maximum
    v = np.where(valid, av, fill)
    out = np.empty(n, dtype=np.float64)
    for s0, e0 in zip(starts_idx, ends):
        seg = v[s0:e0]
        m = len(seg)
        if explicit is not None and running:
            # lo pinned at the partition start: one prefix accumulate,
            # indexed at each row's (exclusive) end — the common
            # running-default shape
            run = acc(seg) if m else seg
            R = hi[s0:e0] - s0
            res = np.where(R > 0, run[np.maximum(R - 1, 0)], fill)
            out[s0:e0] = res
            continue
        if explicit is not None:
            # arbitrary monotone [lo, hi) per row: O(1) range min/max via a
            # sparse table (O(m log m) build)
            L = lo[s0:e0] - s0
            R = hi[s0:e0] - s0
            w = R - L
            table = [seg]
            span = 1
            while span * 2 <= m:
                prev = table[-1]
                table.append(red(prev[: m - span * 2 + 1], prev[span: m - span + 1]))
                span *= 2
            res = np.full(m, fill)
            nonempty = w > 0
            if nonempty.any():
                k = np.zeros(m, dtype=np.int64)
                k[nonempty] = np.floor(np.log2(w[nonempty])).astype(np.int64)
                a = np.full(m, fill)
                b = np.full(m, fill)
                for kk in np.unique(k[nonempty]):
                    sel = nonempty & (k == kk)
                    t = table[kk]
                    a[sel] = t[L[sel]]
                    b[sel] = t[R[sel] - (1 << kk)]
                res = np.where(nonempty, red(a, b), fill)
            out[s0:e0] = res
            continue
        # clamp offsets into [-m, m] so a huge frame bound costs O(m), not
        # O(bound). Clamping BOTH directions (not just toward the segment)
        # keeps cs <= ce for any start <= end frame, so the sliding-window
        # width below stays positive even for a same-side frame wider than
        # the segment (e.g. 5 FOLLOWING..10 FOLLOWING over 3 rows — its
        # windows then index only fill padding and yield NULL)
        iseg = np.arange(m)
        cs = None if start is None else min(max(start, -m), m)
        ce = None if end is None else min(max(end, -m), m)
        if cs is None and ce is None:
            out[s0:e0] = acc(seg)[-1] if m else fill
        elif cs is None:
            run = acc(seg)
            out[s0:e0] = run[np.clip(iseg + ce, 0, m - 1)]
            if ce < 0:  # first rows have empty windows
                out[s0:e0][iseg + ce < 0] = fill
        elif ce is None:
            run = acc(seg[::-1])[::-1]
            out[s0:e0] = run[np.clip(iseg + cs, 0, m - 1)]
            if cs > 0:
                out[s0:e0][iseg + cs > m - 1] = fill
        elif ce - cs + 1 <= 0:
            # only reachable for an inverted frame (start > end); clamping
            # preserves bound order, so well-formed frames never land here
            out[s0:e0] = fill
        else:
            w = ce - cs + 1
            pad_before = -min(cs, 0)
            padded = np.concatenate(
                [np.full(pad_before, fill), seg,
                 np.full(max(ce, 0) + max(cs, 0), fill)]
            )
            # window for row i starts at padded[i + cs + pad_before]
            view = np.lib.stride_tricks.sliding_window_view(padded, w)
            sel = view[iseg + cs + pad_before]
            out[s0:e0] = sel.min(axis=1) if fn == "min" else sel.max(axis=1)
    # rows whose frame holds no (valid) rows are NULL per SQL (the fill
    # sentinel survives only when nothing real entered the window; genuine
    # +-inf inputs in an otherwise-real window are indistinguishable — a
    # documented corner)
    return out, out == fill
