"""The comparison that decides `correct`: an answer of the program against
the plain reference's answer to the same query over the same files.

Two numbers per answer (PERF.md §2 gives the limits and the readings they
were set from):
- `mismatches`, compared exactly: a missing, extra or misordered row, a
  key, string, date or integer that differs, a column list that differs;
- `rel_gap`: the widest gap of a float cell, |program - reference| /
  max(|reference|, 1).

The rows are held to the whole of the query's ORDER BY (`ORDER`, a list
of (column, descending) keys), lexicographically: a later key decides
only between rows equal in every earlier one.

A query with LIMIT k ranks rows by a float (`ORDER`'s first key); the
reference then
gives k + MARGIN rows in order. A row of the program's k that is not among
the reference's k is a mismatch unless its reference value lies within
the rel_gap limit of the reference's k-th value (a tie that rounding may
break either way)."""

from __future__ import annotations

import numpy as np
import pyarrow as pa


def _values(col: pa.ChunkedArray) -> list | np.ndarray:
    if pa.types.is_floating(col.type):
        return col.to_numpy(zero_copy_only=False).astype(np.float64)
    if pa.types.is_date32(col.type):
        return col.cast(pa.int32()).to_numpy(zero_copy_only=False).astype(np.int64)
    if pa.types.is_integer(col.type):
        return col.to_numpy(zero_copy_only=False).astype(np.int64)
    return col.to_pylist()


def _gap(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1.0)


def compare(got: pa.Table, want: dict, ref, gap_limit: float) -> tuple:
    """(mismatches, rel_gap, first problem or "") of one answer; `ref` is
    the template's reference module (KEYS, ORDER, LIMIT)."""
    names = list(want)
    if got.column_names != names:
        return 1, 0.0, f"columns {got.column_names} != {names}"
    g = {c: _values(got.column(c)) for c in names}
    w = {c: (v if isinstance(v, list) else np.asarray(v)) for c, v in want.items()}
    n_want = len(w[names[0]])
    k = n_want if ref.LIMIT is None else min(ref.LIMIT, n_want)
    bad, gap, why = 0, 0.0, ""

    def note(msg: str) -> None:
        nonlocal bad, why
        bad += 1
        why = why or msg

    if got.num_rows != k:
        note(f"{got.num_rows} rows, {k} in the reference")
    index = {tuple(w[c][i] for c in ref.KEYS): i for i in range(n_want)}
    seen = set()
    for r in range(got.num_rows):
        key = tuple(g[c][r] for c in ref.KEYS)
        i = index.get(key)
        if i is None:
            note(f"row {key} not in the reference")
            continue
        if i in seen:
            note(f"row {key} twice")
        seen.add(i)
        for c in names:
            if isinstance(g[c], np.ndarray) and g[c].dtype == np.float64:
                gap = max(gap, _gap(float(g[c][r]), float(w[c][i])))
            elif g[c][r] != w[c][i]:
                note(f"row {key}: {c} {g[c][r]!r} != {w[c][i]!r}")
        if ref.LIMIT is not None and i >= k:
            # a row past the reference's k-th: only a tie with the k-th
            col = ref.ORDER[0][0]
            if _gap(float(w[col][i]), float(w[col][k - 1])) > gap_limit:
                note(f"row {key} ranks {i + 1}, outside the first {k}")
    if ref.ORDER is not None:
        for r in range(got.num_rows - 1):
            if _misordered([(g[c][r], g[c][r + 1], desc) for c, desc in ref.ORDER]):
                note(f"rows {r + 1} and {r + 2} not ordered by "
                     + ", ".join(c + (" desc" if d else "") for c, d in ref.ORDER))
    return bad, gap, why


def _misordered(keys: list) -> bool:
    """Whether a row comes wrongly before the next: `keys` holds, per
    ORDER BY key in turn, (this row's value, the next row's, descending)."""
    for a, b, desc in keys:
        if a != b:
            return (a < b) if desc else (a > b)
    return False
