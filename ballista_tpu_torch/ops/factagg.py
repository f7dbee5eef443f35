"""Fact-side aggregation pushdown: Aggregate over a PK-FK join tree.

The reference executes Aggregate(Join(dim, fact)) by materializing the join
then hash-aggregating the joined rows (DataFusion HashJoinExec +
HashAggregateExec; serde rust/core/src/serde/physical_plan/from_proto.rs:
176-214, 370-384). Materialized, the join output is volatile: every query
would pay encode + transfer for millions of joined rows.

Device redesign (eager aggregation + semi-join membership), the JAX
package's ops/factagg.py ported to PyTorch:

  host      dim side of the join (small) executes as-is; its join-key
            column must be unique (checked) -> the join attaches at most
            one dim row per fact row, so aggregates distribute over the
            join. Its sorted keys go to the device, where each query
            matches every fact rank's key against them (match_ranks).
  device    one step over the resident fact layout: fused filters +
            per-key partial aggregates (ops/stage.py sorted_step), masked by
            membership, and — when the planner annotated a Sort+Limit
            epilogue — a two-stage block top-k over the score row, so the
            readback is a candidate pool, not G groups.
  host      attach dim attribute columns to the selected keys, emit the
            aggregate's partial-state rows; the ordinary Final merge, Sort
            and Limit operators above run unchanged on the few rows.

Pattern matched: HashAggregateExec[single|partial] over
 [Filter/Projection/Coalesce]* -> a hash-join tree in which the largest
file-backed scan chain (the fact) sits anywhere reachable through INNER
joins and the LEFT side of SEMI/ANTI joins — directly (q3: orders x
lineitem), nested (q10: ((customer x orders) x lineitem) x nation), or
under a semi filter (q18: the "orderkey IN (big orders)" build side folds
whole into the dim-plan membership). The fact's own join must be INNER,
single equi-key, no residual filter. Joins between it and the root are
normally host-side over the dim plan and must not be keyed on fact columns
— with ONE exception: a coupled secondary dim (q5: supplier joined on
l_suppkey with c_nationkey = s_nationkey coupling) runs per-S_ATTR-class
on device via a static mapped column (_detect_secondary). Fact-side group
keys must be the join key; dim-side group keys are attached
post-aggregation (secondary mode: group keys attach per class); all
aggregate inputs must be fact-side expressions. The device top-k epilogue
additionally requires the fact key among the group keys (one output group
per key); dim-only grouping (q10) uses the member-select readback and the
ordinary final merge re-groups.

The three device steps are plain PyTorch on the stage's device, one
readback each: step_topk, step_select and _step_sec. Rows travel as the
fused stage packs them (int32 rows native, f32 rows bit-cast into one int32
tensor), and the top-k index travels as int32.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from ballista_tpu_torch.ops.runtime import (
    UnsupportedOnDevice,
    readback,
    record_route,
    record_routing_event,
    touch_residency,
    upload,
    widen_cols,
)
from ballista_tpu_torch.ops.stage import (
    FusedAggregateStage,
    _SCAN_TYPES,
    expand_clen,
    plan_data_identity,
    state_column,
    substitute_columns,
)
from ballista_tpu_torch.physical import expr as px
from ballista_tpu_torch.physical.basic import (
    CoalesceBatchesExec,
    FilterExec,
    MergeExec,
    ProjectionExec,
)
from ballista_tpu_torch.utils import tracing

# dim sides larger than this are not "dimension tables"; let the host join
# handle them. The ceiling is host-side cost only (one cached collect +
# sort + unique check; the device holds just the sorted dim keys and their
# rows for the rank match), sized for SF=100 TPC-H dim shapes: q3's
# filtered customer x orders side is ~15M rows, q10's window ~6M.
MAX_DIM_ROWS = 32_000_000

# the non-topk member-select epilogue reads back one column per member and
# re-groups on host; that path keeps a tighter ceiling (MAX_DIM_ROWS is
# sized for the topk epilogue, whose readback is O(k))
MAX_SELECT_MEMBERS = 4_000_000

# group_layout marker for "this output column is the fact join key" — a
# sentinel object so it can never collide with a real dim column name
FACT_KEY = object()
# candidate multiplier for the top-k epilogue: secondary sort keys and f32
# score ties are resolved host-side within this pool
TOPK_POOL = 64
# block width of the two-stage top-k (block maxima, then the candidates of
# the best blocks)
TOPK_BLOCK = 128


def _scan_chain_leaf(node):
    while isinstance(node, (FilterExec, ProjectionExec, CoalesceBatchesExec)):
        node = node.input
    return node if isinstance(node, _SCAN_TYPES) else None


def _chain_bytes(leaf) -> int:
    files = getattr(getattr(leaf, "source", None), "files", None)
    if not files:
        return 0
    return sum(os.path.getsize(f) for f in files if os.path.exists(f))


def _columns_of(e: px.PhysicalExpr, acc: List[int]) -> None:
    if isinstance(e, px.ColumnExpr):
        acc.append(e.index)
    for name in ("left", "right", "expr", "low", "high", "base", "else_expr"):
        c = getattr(e, name, None)
        if isinstance(c, px.PhysicalExpr):
            _columns_of(c, acc)
    for a in getattr(e, "args", []) or []:
        _columns_of(a, acc)
    for w, t in getattr(e, "when_then", []) or []:
        _columns_of(w, acc)
        _columns_of(t, acc)


def int64_keys(keys: np.ndarray) -> Optional[np.ndarray]:
    """Join keys widened to int64 for the device rank match, or None where
    int64 cannot hold them in order (strings, dates, floats, uint64): those
    keys take the host search (member_ranks)."""
    kind, size = keys.dtype.kind, keys.dtype.itemsize
    if kind == "i" or (kind == "u" and size < 8):
        return keys.astype(np.int64, copy=False)
    return None


def match_ranks(rank_keys, dim_keys, dim_order):
    """The rank match on the stage's device, for every fact rank: (matched,
    pos, dim_row): whether its key has a dim row, its position among the
    sorted dim keys (clamped) and that dim row, -1 where unmatched. All
    three are int64 tensors but `matched`; exact, and the same match as
    member_ranks, since both key sides are unique."""
    import torch

    if dim_keys.numel() == 0:
        matched = torch.zeros(rank_keys.shape, dtype=torch.bool, device=rank_keys.device)
        return matched, torch.zeros_like(rank_keys), torch.full_like(rank_keys, -1)
    pos = torch.searchsorted(dim_keys, rank_keys).clamp_(max=dim_keys.numel() - 1)
    matched = dim_keys[pos] == rank_keys
    return matched, pos, torch.where(matched, dim_order[pos], -1)


def top_k_indices(x, k: int):
    """Indices of the k largest values of the 1-D tensor x, in
    jax.lax.top_k's order: descending, and the lower index first among
    equal values (a stable descending sort keeps input order on ties)."""
    import torch

    return torch.sort(x, descending=True, stable=True).indices[:k]


def two_stage_top_k(masked, kk: int):
    """Exact top-kk via block maxima (the JAX package's two_stage_topk):
    a block holding a true top-kk element must rank in the top kk blocks
    by max. Pads with -inf to a multiple of TOPK_BLOCK, takes the kk best
    blocks, then the kk best of their candidates. Both stages follow
    top_k_indices's tie rule, so the pool is the JAX package's, in its
    order."""
    import torch

    n = masked.shape[0]
    B = TOPK_BLOCK
    if n < kk * B:
        return top_k_indices(masked, kk)
    npad = -(-n // B) * B
    m2 = torch.nn.functional.pad(masked, (0, npad - n), value=float("-inf")).reshape(-1, B)
    bidx = top_k_indices(m2.amax(dim=1), kk)
    ci = top_k_indices(m2[bidx].reshape(-1), kk)
    return bidx[ci // B] * B + ci % B


class FactAggregateStage:
    """Device pipeline for one aggregate-over-join. Built via try_build."""

    @staticmethod
    def try_build(agg) -> Optional["FactAggregateStage"]:
        from ballista_tpu_torch.physical.aggregate import needs_exact_float_minmax

        if needs_exact_float_minmax(agg):
            # equality-consumed float MIN/MAX (q2): the inner stage runs
            # with float_bits=False (one row per state field), so its f32
            # min/max would round the result to match nothing. Step aside:
            # the mapped-scan rewrite lowers plain-column MIN/MAX through
            # the order-preserving bijection instead (ops/floatbits.py).
            return None
        try:
            return FactAggregateStage(agg)
        except UnsupportedOnDevice as e:
            from ballista_tpu_torch.ops.kernels import step_aside

            # not the end of the ladder: the mapped rewrite is tried next,
            # but why the fact stage stepped aside stays observable
            record_routing_event("factagg.step_aside")
            return step_aside(f"factagg admission: {e}")

    def __init__(self, agg) -> None:
        from ballista_tpu_torch.logical.plan import JoinType
        from ballista_tpu_torch.physical.aggregate import (
            AggregateFunc,
            AggregateMode,
            HashAggregateExec,
        )
        from ballista_tpu_torch.physical.join import HashJoinExec

        if agg.mode.value not in ("single", "partial"):
            raise UnsupportedOnDevice("fact-agg needs single/partial mode")

        # -- walk down to the join ------------------------------------
        node = agg.input
        stack: List[Tuple[str, object]] = []
        # partitions the framework will actually drive this aggregate with
        # (1 for SINGLE mode / over MergeExec). The fact scan's own count
        # can differ — e.g. a single-partition probe side with a
        # multi-partition fact build side — so fact reads stripe over the
        # driven count (inner.scan_stride below); a 1:1 partition map there
        # would silently aggregate only a fraction of the fact rows.
        n_driven = agg.input.output_partitioning().partition_count()
        while isinstance(node, (FilterExec, ProjectionExec, CoalesceBatchesExec, MergeExec)):
            if isinstance(node, FilterExec):
                stack.append(("filter", node.predicate))
            elif isinstance(node, ProjectionExec):
                stack.append(("project", node.exprs))
            node = node.input
        _WALKABLE = (JoinType.INNER, JoinType.SEMI, JoinType.ANTI)
        if not isinstance(node, HashJoinExec) or node.join_type not in _WALKABLE:
            raise UnsupportedOnDevice("row source is not a foldable hash join")
        if node.filter is not None:
            # a residual filter is an index-based expr over concat(left,
            # right); rebuilding the dim plan with the fact block removed
            # would silently shift what it reads
            raise UnsupportedOnDevice("root join has a residual filter")
        root = node

        # -- locate the fact scan chain anywhere in the join tree -------
        # Paths may cross INNER HashJoinExec nodes (their output schema is
        # the concatenation of their children, so removing the fact block
        # keeps every other column's relative order) and the LEFT side of
        # SEMI/ANTI joins (their output schema IS the left schema; the
        # filtering build side stays whole inside the dim plan). The fact
        # is the largest file-backed scan chain reachable that way.
        candidates: List[Tuple[list, HashJoinExec, str, int]] = []

        def dfs(j, path):
            sides = ("left",) if j.join_type != JoinType.INNER else ("left", "right")
            for side in sides:
                child = getattr(j, side)
                leaf = _scan_chain_leaf(child)
                if leaf is not None:
                    b = _chain_bytes(leaf)
                    if b > 0:
                        candidates.append((list(path), j, side, b))
                elif (
                    isinstance(child, HashJoinExec)
                    and child.join_type in _WALKABLE
                    and child.filter is None
                ):
                    dfs(child, path + [(j, side)])

        dfs(root, [])
        if not candidates:
            raise UnsupportedOnDevice("no file-backed scan side")
        path, join, fact_side, _ = max(candidates, key=lambda c: c[3])
        if join.join_type != JoinType.INNER:
            # aggregates distribute over the fact's own join only when it
            # attaches at most one dim row per fact row (INNER + unique key)
            raise UnsupportedOnDevice("fact join is not inner")
        if join.filter is not None or len(join.on) != 1:
            raise UnsupportedOnDevice("fact join shape (residual filter / multi-key)")
        self.fact_plan = getattr(join, fact_side)
        fact_n = len(self.fact_plan.schema())
        # joins between the root and the fact join normally run on the host
        # over the dim plan, so they must not need fact columns. ONE shape
        # of fact-column-keyed upper join is supported: the coupled
        # secondary dim (q5) — see _detect_secondary.
        fact_names = set(self.fact_plan.schema().names)
        offending = [
            i for i, (j, _side) in enumerate(path)
            if any(ln in fact_names or rn in fact_names for ln, rn in j.on)
        ]
        self.secondary: Optional[dict] = None
        if offending:
            self._detect_secondary(path, offending, join, fact_side, fact_names)
        # offset of the fact block within the root's flattened schema
        fact_offset = 0
        for j, side in path + [(join, fact_side)]:
            if side == "right":
                fact_offset += len(j.left.schema())
        lkey, rkey = join.on[0]
        self.fact_key = lkey if fact_side == "left" else rkey
        self.dim_key = rkey if fact_side == "left" else lkey
        fact_key_idx = self.fact_plan.schema().names.index(self.fact_key)

        # -- dim plan: the join tree with the fact subtree removed ------
        # In secondary mode every path join belongs to the SECONDARY plan
        # (built in _detect_secondary); the primary dim plan is just the
        # fact join's other side.
        replacement = join.left if fact_side == "right" else join.right
        if self.secondary is None:
            for j, side in reversed(path):
                children = [j.left, j.right]
                children[0 if side == "left" else 1] = replacement
                replacement = j.with_children(children)
        self.dim_plan = replacement

        # -- re-express aggregate exprs over the root join schema -------
        join_schema = root.schema()
        mapping: List[px.PhysicalExpr] = [
            px.ColumnExpr(f.name, i) for i, f in enumerate(join_schema)
        ]
        above_filters: List[px.PhysicalExpr] = []
        for kind, payload in reversed(stack):
            if kind == "project":
                mapping = [substitute_columns(e, mapping) for e, _ in payload]
            else:
                above_filters.append(substitute_columns(payload, mapping))

        def side_of(e: px.PhysicalExpr) -> str:
            cols: List[int] = []
            _columns_of(e, cols)
            in_fact = [fact_offset <= c < fact_offset + fact_n for c in cols]
            if all(in_fact):
                return "fact"
            if not any(in_fact):
                return "dim"
            return "mixed"

        # fact-index remap: join-schema column -> fact-plan column
        fact_map: List[px.PhysicalExpr] = []
        for i, f in enumerate(join_schema):
            if fact_offset <= i < fact_offset + fact_n:
                fact_map.append(px.ColumnExpr(f.name, i - fact_offset))
            else:
                fact_map.append(px.LiteralExpr(None, pa.null()))

        def to_fact(e: px.PhysicalExpr) -> px.PhysicalExpr:
            return substitute_columns(e, fact_map)

        # group keys: the fact side may contribute only the join key; dim
        # keys become post-aggregation attachments. Secondary mode instead
        # requires every group key to be a secondary-plan column (q5 groups
        # by n_name): values attach per allowed S_ATTR class.
        self.group_layout: List[Tuple[object, str]] = []
        sec_group_cols: List[Tuple[str, str]] = []
        for e, name in [(substitute_columns(e, mapping), n) for e, n in agg.group_exprs]:
            s = side_of(e)
            if self.secondary is not None:
                if not (
                    isinstance(e, px.ColumnExpr)
                    and e.index >= self.secondary["sec_start"]
                    and e.name in self.secondary["plan"].schema().names
                ):
                    raise UnsupportedOnDevice(
                        "secondary mode requires secondary-side group keys"
                    )
                sec_group_cols.append((e.name, name))
                continue
            if s == "fact":
                if not (isinstance(e, px.ColumnExpr) and e.index - fact_offset == fact_key_idx):
                    raise UnsupportedOnDevice("fact-side group key is not the join key")
                self.group_layout.append((FACT_KEY, name))
            elif s == "dim" and isinstance(e, px.ColumnExpr):
                ri = e.index if e.index < fact_offset else e.index - fact_n
                dim_name = self.dim_plan.schema().names[ri]
                if dim_name != e.name:
                    raise UnsupportedOnDevice("dim column remap mismatch")
                self.group_layout.append((dim_name, name))
            else:
                raise UnsupportedOnDevice("unsupported group key shape")
        if self.secondary is not None:
            self.secondary["group_cols"] = sec_group_cols

        fact_filters = []
        for f in above_filters:
            if side_of(f) != "fact":
                raise UnsupportedOnDevice("non-fact filter above the join")
            fact_filters.append(to_fact(f))

        syn_aggs = []
        for a in agg.aggr_funcs:
            e = substitute_columns(a.expr, mapping)
            if side_of(e) not in ("fact",):
                raise UnsupportedOnDevice("aggregate input not on the fact side")
            syn_aggs.append(
                AggregateFunc(a.fn, to_fact(e), a.name, a.dtype, a.input_type)
            )
        self.aggs = agg.aggr_funcs

        # -- synthetic partial aggregate over the fact chain -----------
        fact_input = self.fact_plan
        for f in fact_filters:
            fact_input = FilterExec(fact_input, f)
        syn = HashAggregateExec(
            AggregateMode.PARTIAL,
            fact_input,
            [(px.ColumnExpr(self.fact_key, fact_key_idx), self.fact_key)],
            syn_aggs,
        )
        # float_bits=False: the readback and row math here address one row
        # per state FIELD (_score_row, _decode); f64-bijected min/max states
        # occupy two key-plane rows, which this path cannot carry. Float
        # min/max here keeps the documented f32 semantics.
        self.inner = FusedAggregateStage(syn, float_bits=False)
        # chunk partials must BE group partials (member mask / top-k index
        # group space): widen L1 to the longest key run
        self.inner.sorted_cover_max = True
        n_fact = self.fact_plan.output_partitioning().partition_count()
        if n_driven != n_fact:
            # stripe fact partitions over the driven partitions so every
            # fact row is read exactly once (n_driven=1: read them all)
            self.inner.scan_stride = n_driven
        if not self.inner.cacheable:
            raise UnsupportedOnDevice("fact side not cacheable")
        if self.secondary is not None:
            # F2 (the secondary fact key, e.g. l_suppkey) as a scan-space
            # column: compiling it registers it with the column loader, and
            # the derived-column hook materializes the static mapped S_ATTR
            # per row beside the resident tiles
            sec = self.secondary
            f2_fact_idx = self.fact_plan.schema().names.index(sec["f2"])
            f2_scan = substitute_columns(
                px.ColumnExpr(sec["f2"], f2_fact_idx), self.inner.input_to_scan
            )
            if not isinstance(f2_scan, px.ColumnExpr):
                raise UnsupportedOnDevice("secondary fact key is not a column")
            cv = self.inner.compiler.compile(f2_scan)
            if cv.kind == "code":
                raise UnsupportedOnDevice("string secondary fact key")
            sec["f2_scan_idx"] = f2_scan.index
            self._sec_map = None  # (sorted base S_KEYs, their S_ATTRs)
            self.inner.derive_columns["sec_attr"] = self._derive_sec_attr
            self.inner.derive_identity["sec_attr"] = self._sec_attr_identity
        self.partial_schema = FusedAggregateStage._partial_schema(agg)
        # planner-provided Sort+Limit epilogue (physical/planner.py)
        self.topk = getattr(agg, "_topk_pushdown", None)
        self.partitions = n_driven
        if self.topk is not None and (
            self.partitions != 1
            or self.aggs[self.topk["agg_index"]].fn != "sum"
            or self.topk["k"] > (1 << 16)
            or all(src is not FACT_KEY for src, _ in self.group_layout)
        ):
            # per-partition partial sums cannot drive a global top-k, the
            # score must be a plain SUM state, the candidate pool is capped
            # at 64k groups, and the output groups must BE the fact keys:
            # when the query groups by dim attributes only (q10), many keys
            # fold into one group in the final merge and a per-key top-k
            # ranks the wrong thing. The member-select readback runs instead
            self.topk = None
        if self.secondary is not None:
            self.route = "fact_secondary"
        else:
            self.route = "fact_topk" if self.topk is not None else "fact_select"
        self._dim_cache: Optional[dict] = None  # guarded-by: self.inner._prepare_lock
        self._prepared: Dict[int, dict] = {}  # guarded-by: self.inner._prepare_lock
        self._sec_cache: Optional[dict] = None  # guarded-by: self.inner._prepare_lock
        if self.secondary is not None and any(self.inner.int_exact):
            # secondary-mode reductions span the whole partition in one
            # sum; int32 accumulation could overflow silently
            raise UnsupportedOnDevice("int-exact aggregate in secondary mode")

    # ------------------------------------------------------------------
    def _detect_secondary(self, path, offending, join, fact_side, fact_names):
        """q5 shape: ONE upper join keyed on a fact column, adjacent to the
        fact join, whose other side is an unfiltered scan chain (the
        secondary dim), with exactly one extra key pair coupling a PRIMARY
        column to a secondary column:

            J2: [fact.F2 = sec.S_KEY, prim.P = sec.S_ATTR]

        The aggregation then runs per S_ATTR value on device: a STATIC
        mapped column M[row] = S_ATTR of row's F2 (valid because the
        secondary base is unfiltered) compared against the per-rank primary
        coupling value and the query-time allowed S_ATTR set. Joins above
        J2 fold into the secondary plan (supplier * nation * region for q5)
        and must not touch fact or primary columns. Raises to fall back."""
        from ballista_tpu_torch.logical.plan import JoinType

        if offending != [len(path) - 1]:
            raise UnsupportedOnDevice("fact-column upper join not adjacent")
        j2, side2 = path[-1]
        if j2.join_type != JoinType.INNER or j2.filter is not None:
            raise UnsupportedOnDevice("secondary join shape")
        if side2 != "left" or any(s != "left" for _j, s in path):
            # fact+primary under j2.left keeps the secondary block a suffix
            # of the flattened schema
            raise UnsupportedOnDevice("secondary fold needs left-leaning joins")
        sec_base = j2.right
        if _scan_chain_leaf(sec_base) is None:
            raise UnsupportedOnDevice("secondary side is not a scan chain")
        node = sec_base
        while isinstance(node, (ProjectionExec, CoalesceBatchesExec, FilterExec)):
            if isinstance(node, FilterExec):
                # the static map must not depend on query-time predicates
                raise UnsupportedOnDevice("filtered secondary base")
            node = node.input
        sec_names = set(sec_base.schema().names)
        prim_plan = join.left if fact_side == "right" else join.right
        prim_names = set(prim_plan.schema().names)
        f2 = s_key = p = s_attr = None
        for ln, rn in j2.on:
            lef, rig = (ln, rn) if rn in sec_names else (rn, ln)
            if rig not in sec_names:
                raise UnsupportedOnDevice("secondary join key resolution")
            if lef in fact_names:
                if f2 is not None:
                    raise UnsupportedOnDevice("two fact-keyed pairs")
                f2, s_key = lef, rig
            elif lef in prim_names:
                if p is not None:
                    raise UnsupportedOnDevice("two coupling pairs")
                p, s_attr = lef, rig
            else:
                raise UnsupportedOnDevice("secondary join key from unknown side")
        if f2 is None or p is None:
            raise UnsupportedOnDevice("secondary join missing fact key or coupling")
        if not pa.types.is_integer(prim_plan.schema().field(p).type):
            raise UnsupportedOnDevice("coupling column must be integer")
        for j, _s in path[:-1]:
            for ln, rn in j.on:
                if {ln, rn} & (fact_names | prim_names):
                    raise UnsupportedOnDevice("upper join not secondary-only")
        sec_plan = sec_base
        for j, s in reversed(path[:-1]):
            children = [j.left, j.right]
            children[0 if s == "left" else 1] = sec_plan
            sec_plan = j.with_children(children)
        self.secondary = {
            "plan": sec_plan,
            "base": sec_base,
            "f2": f2,
            "s_key": s_key,
            "p": p,
            "s_attr": s_attr,
            "sec_start": len(j2.left.schema()),
        }

    # ------------------------------------------------------------------
    # holds-lock: self.inner._prepare_lock
    def _ensure_sec_map(self, ctx) -> None:
        """Static secondary mapping: sorted base S_KEYs and their S_ATTRs.
        Valid across queries because the base chain is unfiltered."""
        if self._sec_map is not None:
            return
        from ballista_tpu_torch.physical.plan import collect_all

        sec = self.secondary
        base = collect_all(sec["base"], ctx)
        if base.num_rows > MAX_DIM_ROWS:
            raise UnsupportedOnDevice("secondary base too large")
        k = base.column(sec["s_key"]).to_numpy(zero_copy_only=False)
        a = base.column(sec["s_attr"]).to_numpy(zero_copy_only=False)
        if not (np.issubdtype(k.dtype, np.integer) and np.issubdtype(a.dtype, np.integer)):
            raise UnsupportedOnDevice("secondary keys must be integers")
        if len(a) and int(a.min()) < 0:
            raise UnsupportedOnDevice("negative secondary attribute")
        order = np.argsort(k, kind="stable")
        ks = k[order]
        if len(np.unique(ks)) != len(ks):
            raise UnsupportedOnDevice("secondary key not unique")
        self._sec_map = (ks.astype(np.int64), a[order].astype(np.int32))

    def _sec_attr_identity(self) -> Optional[str]:
        """What the derived column is a function of besides the fact's own
        columns: the unfiltered secondary base (its display and files) and
        the key pair that maps F2 to S_ATTR through it."""
        sec = self.secondary
        base = plan_data_identity(sec["base"])
        if base is None:
            return None
        return f"{sec['f2']}->{sec['s_key']}:{sec['s_attr']}|{base}"

    def _derive_sec_attr(self, npcols) -> np.ndarray:
        """Row-space static mapped column: S_ATTR of each row's F2 value
        (-1 when the base holds no such key — the row can never qualify)."""
        keys, attrs = self._sec_map
        f2 = npcols[self.secondary["f2_scan_idx"]].astype(np.int64)
        if len(keys) == 0:
            return np.full(len(f2), -1, dtype=np.int32)
        pos = np.clip(np.searchsorted(keys, f2), 0, len(keys) - 1)
        matched = keys[pos] == f2
        return np.where(matched, attrs[pos], -1).astype(np.int32)

    def _sec_side(self, ctx) -> dict:
        """Query-time secondary plan: allowed S_ATTR classes and the group
        key values attached to each. Declines when qualification is not a
        pure function of S_ATTR (the static map cannot express per-key
        filtering) or when group values are not unique per class."""
        with self.inner._prepare_lock:
            if self._sec_cache is not None:
                return self._sec_cache
            with tracing.span("factagg.secondary_side"):
                return self._sec_side_locked(ctx)

    # holds-lock: self.inner._prepare_lock
    def _sec_side_locked(self, ctx) -> dict:
        # collects the secondary dimension plan under the lock
        # may-acquire: group:exec_substrate
        from ballista_tpu_torch.physical.plan import collect_all

        sec = self.secondary
        self._ensure_sec_map(ctx)
        base_keys, base_attrs = self._sec_map
        table = collect_all(sec["plan"], ctx)
        attrs = table.column(sec["s_attr"]).to_numpy(zero_copy_only=False)
        keys = table.column(sec["s_key"]).to_numpy(zero_copy_only=False)
        pairs = np.unique(np.stack([attrs.astype(np.int64), keys.astype(np.int64)]), axis=1)
        if pairs.shape[1] != len(attrs):
            # duplicate (attr, key) rows: an upper secondary join multiplies
            # supplier rows, so each fact row should count more than once —
            # the per-class device mask cannot express that
            raise UnsupportedOnDevice("secondary plan multiplies rows")
        allowed, sec_counts = np.unique(pairs[0], return_counts=True)
        b_allowed, b_counts = np.unique(
            base_attrs[np.isin(base_attrs, allowed.astype(np.int32))],
            return_counts=True,
        )
        if not (
            len(allowed) == len(b_allowed)
            and (allowed == b_allowed).all()
            and (sec_counts == b_counts).all()
        ):
            raise UnsupportedOnDevice("secondary qualification not attr-pure")
        if len(allowed) > 256:
            raise UnsupportedOnDevice("too many secondary classes")
        # group values: unique per class, gathered in `allowed` order from
        # each class's first row
        group_values = {}
        uniq_attrs, first_idx = np.unique(attrs.astype(np.int64), return_index=True)
        first_row_for_attr = dict(zip(uniq_attrs.tolist(), first_idx.tolist()))
        for name, _out in sec["group_cols"]:
            col = table.column(name)
            if isinstance(col, pa.ChunkedArray):
                col = col.combine_chunks()
            codes = pc.dictionary_encode(col).indices.to_numpy(zero_copy_only=False)
            per_class = np.unique(
                np.stack([attrs.astype(np.int64), codes.astype(np.int64)]), axis=1
            )
            if len(per_class[0]) != len(allowed):
                raise UnsupportedOnDevice("group key not unique per secondary class")
            take = pa.array([first_row_for_attr[int(v)] for v in allowed], type=pa.int64())
            group_values[name] = col.take(take)
        out = {"allowed": allowed.astype(np.int32), "group_values": group_values}
        if ctx.config.device_cache():
            self._sec_cache = out
        return out

    def _step_sec(self, ent: dict, aux, p_rank, allowed: np.ndarray):
        """Per-class masked full reductions (the JAX package's
        _build_sec_step): every aggregate state for every allowed S_ATTR
        class, as one int32 [R, GA] tensor in the fused stage's packing."""
        import torch

        inner = self.inner
        cols = widen_cols(ent["cols"])
        m_tiles = ent["derived"]["sec_attr"].to(torch.int32)  # derived tiles ride narrow
        mask0 = expand_clen(ent["clen"], ent["layout"].L1)
        for fm in inner.filter_masks:
            mask0 = torch.logical_and(mask0, fm(cols, aux))

        def reduce_extreme(v, fill, red):
            return v.amax() if red == "max" else v.amin()

        def reduce_extreme_pair(hi, lo, fill, red):
            # float_bits=False: no stage state rides a (hi, lo) plane pair
            raise AssertionError("plane pairs do not occur in fact stages")

        outs = []
        for a in allowed.tolist():
            m = torch.logical_and(mask0, m_tiles == a)
            # coupling: the rank's primary value must equal the class
            # (non-member ranks carry -1 and never match)
            m = torch.logical_and(m, (p_rank == a)[:, None])
            rows = inner._emit_rows(
                cols, aux, m,
                counts=m.sum(dtype=torch.int32),
                reduce_sum=lambda v, zero: v.sum(dtype=v.dtype),
                reduce_extreme=reduce_extreme,
                reduce_extreme_pair=reduce_extreme_pair,
            )
            outs.append(inner._pack_rows(rows))
        return torch.stack(outs, dim=1)

    def _run_secondary(self, ent: dict, ctx) -> pa.Table:
        sec = self.secondary
        info = self._sec_side(ctx)
        prim = self._dim_side(ctx)
        if (
            ent["kind"] == "empty"
            or len(info["allowed"]) == 0
            or prim["table"].num_rows == 0
        ):
            return self.partial_schema.empty_table()
        import torch

        # per-rank coupling value from the primary side (-1 = no match)
        p_col = prim["table"].column(sec["p"]).to_numpy(zero_copy_only=False)
        if not np.issubdtype(p_col.dtype, np.integer):
            raise UnsupportedOnDevice("coupling column must be integer")
        dev = self.inner.device
        with tracing.span("factagg.rank_search"):
            match = self._device_match(ent, prim)
            if match is not None:
                matched, pos, _ = match
                p_rank = torch.where(matched, prim["p_sorted_dev"][pos], -1).to(torch.int32)
            else:
                ranks, dim_rows = self.member_ranks(ent, prim)
                p_host = np.full(len(ent["rank_keys"]), -1, dtype=np.int32)
                p_host[ranks] = p_col[dim_rows]
                p_rank = upload(p_host, dev)

        aux = [upload(np.asarray(a), dev) for a in self.inner.compiler.build_aux()]
        rows = self._decode(readback(
            self._step_sec(ent, aux, p_rank, info["allowed"])
        ))
        counts = rows[0]
        keep = counts > 0
        fields = list(self.partial_schema)
        arrays: List[pa.Array] = []
        fi = 0
        keep_idx = pa.array(np.flatnonzero(keep).astype(np.int64))
        for name, _out in sec["group_cols"]:
            f = fields[fi]
            arr = info["group_values"][name].take(keep_idx)
            if arr.type != f.type:
                arr = pc.cast(arr, f.type)
            arrays.append(arr)
            fi += 1
        state_rows = rows[1:]
        ri = 0
        nonempty = counts[keep]
        for a in self.aggs:
            for _sf in a.state_fields():
                f = fields[fi]
                raw = state_rows[ri][keep]
                arrays.append(state_column(a, raw, f.type, nonempty == 0))
                ri += 1
                fi += 1
        return pa.table(arrays, schema=self.partial_schema)

    # ------------------------------------------------------------------
    def _score_row(self) -> int:
        """Logical result-row index of the top-k score (the j-th
        aggregate's first state row; row 0 is counts)."""
        row = 1
        for a in self.aggs[: self.topk["agg_index"]]:
            row += len(a.state_fields())
        return row

    def pool_size(self, n_groups: int) -> int:
        """kk, the candidate pool the top-k step reads back: at least
        TOPK_POOL, 4k for larger k, at most 2^16, at most the groups."""
        return min(min(max(4 * self.topk["k"], TOPK_POOL), 1 << 16), n_groups)

    def step_topk(self, ent: dict, aux, dim_row):
        """The JAX package's step_topk: the sorted step, valid = member &
        counts > 0 (a member rank has a dim row: dim_row >= 0, the JAX
        package's member bits), the score row ranked as f32 (int sums cast,
        as the reference does) and the two-stage block top-k. Returns ONE
        int32 [R + 4, kk] tensor: the selected packed rows, the masked
        score's f32 bits, the group index, the valid flag and the dim row."""
        import torch

        inner = self.inner
        rows = inner.sorted_step(ent["layout"].L1, ent["cols"], aux, ent["clen"])
        valid = torch.logical_and(dim_row >= 0, rows[0] > 0)
        score = rows[self._score_row()].to(torch.float32)
        if not self.topk["descending"]:
            score = -score
        masked = torch.where(valid, score, float("-inf"))
        idx = two_stage_top_k(masked, self.pool_size(masked.shape[0]))
        return torch.cat([
            inner._pack_rows(rows)[:, idx],
            masked[idx].view(torch.int32)[None, :],
            idx.to(torch.int32)[None, :],
            valid[idx].to(torch.int32)[None, :],
            dim_row[idx].to(torch.int32)[None, :],
        ])

    def step_select(self, ent: dict, aux, positions):
        """The JAX package's step_select: the sorted step's packed rows at
        the member ranks, [R, members] int32. Eager PyTorch compiles
        nothing per shape, so the positions are not padded to a bucket."""
        inner = self.inner
        rows = inner.sorted_step(ent["layout"].L1, ent["cols"], aux, ent["clen"])
        return inner._pack_rows(rows)[:, positions]

    # ------------------------------------------------------------------
    def _dim_side(self, ctx) -> dict:
        """Execute (+ cache, if enabled) the dim side; build key->row index.
        Serialized with the stage's prepare lock: concurrent first-touch
        partitions must not each collect the dim plan. The host work is one
        span, which chip_smoke.py reports per query."""
        with self.inner._prepare_lock:
            if self._dim_cache is not None:
                return self._dim_cache
            with tracing.span("factagg.dim_side"):
                return self._dim_side_locked(ctx)

    # holds-lock: self.inner._prepare_lock
    def _dim_side_locked(self, ctx) -> dict:
        # collects the dimension plan (joins on the card included) under the lock
        # may-acquire: group:exec_substrate
        from ballista_tpu_torch.physical.plan import collect_all

        table = collect_all(self.dim_plan, ctx)
        if table.num_rows > MAX_DIM_ROWS:
            raise UnsupportedOnDevice("dim side too large")
        keys = table.column(self.dim_key)
        if keys.null_count:
            table = table.filter(pc.is_valid(keys))
            keys = table.column(self.dim_key)
        kn = keys.to_numpy(zero_copy_only=False)
        if len(np.unique(kn)) != len(kn):
            raise UnsupportedOnDevice("dim join key not unique")
        order = np.argsort(kn, kind="stable")
        out = {"table": table, "keys_sorted": kn[order], "order": order}
        keys64 = int64_keys(out["keys_sorted"])
        if keys64 is not None:
            # the rank match's dim side on the card (_device_match), and a
            # secondary stage's coupling column in the same sorted order
            dev = self.inner.device
            out["keys_dev"] = upload(keys64, dev)
            out["order_dev"] = upload(order.astype(np.int64, copy=False), dev)
            if self.secondary is not None:
                p = table.column(self.secondary["p"]).to_numpy(zero_copy_only=False)
                if np.issubdtype(p.dtype, np.integer):
                    out["p_sorted_dev"] = upload(p[order].astype(np.int64), dev)
        if ctx.config.device_cache():
            self._dim_cache = out
        return out

    def _prepare(self, partition: int, ctx) -> dict:
        # concurrent executor task threads: serialize prepare (shared
        # growing dictionaries), same as the inner stage's own lock
        with self.inner._prepare_lock:
            ent = self._prepared.get(partition)
            if ent is not None:
                touch_residency(self, partition)  # LRU recency for eviction
                return ent
            return self._prepare_locked(partition, ctx)

    # holds-lock: self.inner._prepare_lock
    def _prepare_locked(self, partition: int, ctx) -> dict:
        if self.secondary is not None:
            self._ensure_sec_map(ctx)  # the derived column needs the map
        if not ctx.config.device_cache():
            # ballista.tpu.device_cache=false: recompute per query instead
            # of pinning the [V, L1] tiles
            return self._prepare_entry(partition, ctx)
        # pinned entries count against the device budget (beyond it the
        # partition streams per query); a fact stage whose inner layout
        # another stage already holds binds it
        return self.inner.bind_or_prepare(partition, ctx, self, self._prepared,
                                          self._prepare_entry)

    # holds-lock: self.inner._prepare_lock
    def _prepare_entry(self, partition: int, ctx) -> dict:
        # executes the fact side's input subtree under the lock
        # may-acquire: group:exec_substrate
        """The inner stage's sorted partition with its rank keys, which are
        a function of the fact's key values alone."""
        with tracing.span("stage.prepare"):
            ent = self.inner._prepare_partition_sorted(partition, ctx)
        if ent["kind"] == "sorted":
            if not ent["layout"].one_chunk_per_group:
                raise UnsupportedOnDevice("fact key runs exceed one chunk")
            kv = ent["key_values"][0]
            kv_np = (kv.to_numpy(zero_copy_only=False)
                     if isinstance(kv, (pa.Array, pa.ChunkedArray)) else np.asarray(kv))
            ent["rank_keys"] = kv_np
            keys64 = int64_keys(kv_np)
            if keys64 is not None:
                # resident beside the tiles (counted, pinned and evicted
                # with them): each query's rank match runs on the card
                ent["rank_keys_dev"] = upload(keys64, self.inner.device)
            else:
                ent["rank_order"] = np.argsort(kv_np, kind="stable")
        return ent

    # ------------------------------------------------------------------
    def run(self, partition: int, ctx) -> pa.Table:
        self.inner.bind_device(ctx)
        if self.secondary is not None:
            out = self._run_secondary(self._prepare(partition, ctx), ctx)
        else:
            out = self._run_primary(partition, ctx)
        record_route(self.route)
        return out

    def member_ranks(self, ent: dict, dim: dict) -> Tuple[np.ndarray, np.ndarray]:
        """The host search: (fact ranks whose key has a dim row, in key
        order, and that dim row per rank). It runs where a key side is not
        integer (_device_match), and is the device match's oracle."""
        rank_keys = ent["rank_keys"]
        rank_order = ent.get("rank_order")
        if rank_order is None:
            rank_order = np.argsort(rank_keys, kind="stable")
        sorted_keys = rank_keys[rank_order]
        pos = np.searchsorted(sorted_keys, dim["keys_sorted"])
        pos = np.clip(pos, 0, len(sorted_keys) - 1)
        matched = sorted_keys[pos] == dim["keys_sorted"]
        return rank_order[pos[matched]], dim["order"][matched]

    def _device_match(self, ent: dict, dim: dict):
        """match_ranks over the resident fact and dim keys, or None (the
        host search runs) where either side's keys are not integers.
        Counted once per partition run, by the path taken."""
        if "rank_keys_dev" not in ent or "keys_dev" not in dim:
            tracing.incr("factagg.rank_match.host")
            return None
        tracing.incr("factagg.rank_match.device")
        return match_ranks(ent["rank_keys_dev"], dim["keys_dev"], dim["order_dev"])

    def _run_primary(self, partition: int, ctx) -> pa.Table:
        import torch

        dim = self._dim_side(ctx)
        if self.topk is None and dim["table"].num_rows > MAX_SELECT_MEMBERS:
            # members <= dim rows: decline BEFORE prepare pays the fact
            # upload (the per-query check below would fire after it)
            raise UnsupportedOnDevice("member-select dim side too large")
        ent = self._prepare(partition, ctx)
        if ent["kind"] == "empty" or dim["table"].num_rows == 0:
            return self.partial_schema.empty_table()
        dev = self.inner.device
        with tracing.span("factagg.rank_search"):
            match = self._device_match(ent, dim)
            if match is None:
                ranks, dim_rows = self.member_ranks(ent, dim)
            elif self.topk is None:
                matched, pos, dim_row = match
                ranks = torch.nonzero(matched).squeeze(1)
                # member_ranks' order: by key, which is by dim position
                ranks = ranks[torch.argsort(pos[ranks])]
                dim_rows = dim_row[ranks]
        aux = [upload(np.asarray(a), dev) for a in self.inner.compiler.build_aux()]
        if self.topk is not None:
            if match is not None:
                dim_row = match[2]
            else:
                rank_to_dim = np.full(ent["n_groups"], -1, dtype=np.int64)
                rank_to_dim[ranks] = dim_rows
                dim_row = upload(rank_to_dim, dev)
            packed = readback(self.step_topk(ent, aux, dim_row))
            n_rows = len(self.inner._int_rows)
            valid = packed[n_rows + 2] > 0
            sel = packed[:n_rows][:, valid]
            scores = packed[n_rows].view(np.float32)[valid]
            idx = packed[n_rows + 1].astype(np.int64)[valid]
            # A tie at the k-th score reaching the candidate-pool edge means
            # the pool may not contain every qualifying group. Two causes:
            # - strict (secondary sort keys): groups outside the pool could
            #   legitimately outrank pool members on the tie-breakers.
            # - integer SUM scores rank as f32; above 2^24 distinct sums
            #   collapse into FALSE ties. f32 rounding is monotone, so a
            #   wrongly-excluded group forces f32(kth) <= f32(pool edge) —
            #   exactly this condition. Within the pool the upper Sort
            #   re-orders on exact decoded ints.
            k = self.topk["k"]
            tie_val = scores[min(k - 1, len(scores) - 1)] if len(scores) else 0.0
            # int scores below 2^24 are exact in f32: a boundary tie there
            # is genuine, and non-strict genuine ties may break arbitrarily
            score_exact_risk = (
                self.inner._int_rows[self._score_row()]
                and abs(float(tie_val)) >= float(1 << 24)
            )
            if (
                (self.topk.get("strict") or score_exact_risk)
                and valid.all()
                and len(scores) > k
                and tie_val <= scores[-1]
            ):
                raise UnsupportedOnDevice("top-k tie at candidate boundary")
            dim_idx = packed[n_rows + 3].astype(np.int64)[valid]
            return self._assemble(sel, idx, dim_idx, dim["table"], ent)
        if ranks.shape[0] == 0:
            return self.partial_schema.empty_table()
        if ranks.shape[0] > MAX_SELECT_MEMBERS:
            # the non-topk epilogue reads back [state_rows, members]: past
            # this the transfer and host re-group cost more than the host
            # path; decline
            raise UnsupportedOnDevice("member-select readback too large")
        if match is None:
            ranks, dim_rows = upload(ranks.astype(np.int64), dev), upload(dim_rows, dev)
        # one readback: the member rows, then their ranks and dim rows
        packed = readback(torch.cat([
            self.step_select(ent, aux, ranks),
            ranks.to(torch.int32)[None, :],
            dim_rows.to(torch.int32)[None, :],
        ]))
        ranks, dim_rows = packed[-2].astype(np.int64), packed[-1].astype(np.int64)
        rows = self._decode(packed[:-2])
        keep = rows[0] > 0
        return self._assemble_decoded(
            [r[keep] for r in rows], ranks[keep], dim_rows[keep],
            dim["table"], ent,
        )

    def _decode(self, packed: np.ndarray) -> List[np.ndarray]:
        """Readback rows -> logical rows: int rows int64, f32 rows
        widened to f64."""
        return [
            r if r.dtype == np.int64 else r.astype(np.float64)
            for r in self.inner._unpack_rows(packed)
        ]

    def _assemble(self, sel, ranks, dim_idx, dim_table, ent) -> pa.Table:
        rows = self._decode(sel)
        keep = rows[0] > 0
        return self._assemble_decoded(
            [r[keep] for r in rows], ranks[keep], dim_idx[keep], dim_table, ent
        )

    def _assemble_decoded(self, rows, ranks, dim_idx, dim_table, ent) -> pa.Table:
        """Partial-state table for the selected groups: group keys in the
        original order (fact key value / dim attachments), then states."""
        counts, states = rows[0], rows[1:]
        fields = list(self.partial_schema)
        arrays: List[pa.Array] = []
        take_dim = pa.array(dim_idx.astype(np.int64))
        fi = 0
        for src, _name in self.group_layout:
            f = fields[fi]
            if src is FACT_KEY:
                arr = pa.array(ent["rank_keys"][ranks])
            else:
                arr = dim_table.column(src).take(take_dim)
                if isinstance(arr, pa.ChunkedArray):
                    arr = arr.combine_chunks()
            if arr.type != f.type:
                arr = pc.cast(arr, f.type)
            arrays.append(arr)
            fi += 1
        si = 0
        nonempty = counts > 0  # all true post-filter; kept for min/max nulls
        for a in self.aggs:
            for _ in a.state_fields():
                f = fields[fi]
                arrays.append(state_column(a, states[si], f.type, ~nonempty))
                si += 1
                fi += 1
        return pa.table(arrays, schema=self.partial_schema)
