"""Vectorized join index computation (host path).

Sort + binary-search join over dense int64 key codes — deliberately the same
algorithm the TPU backend lowers with jnp.searchsorted/gather
(ballista_tpu/ops/join.py), so host and device paths share semantics.

Key normalization: every key column (any Arrow type, incl. strings) is
factorized to int64 codes jointly across both sides; composite keys combine
code columns into one dense int64. Null keys never match (SQL semantics).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc


def _codes_for(left: pa.Array, right: pa.Array) -> Tuple[np.ndarray, np.ndarray, int]:
    """Jointly factorize two arrays to int64 codes; null -> -1."""
    lc = left.combine_chunks() if isinstance(left, pa.ChunkedArray) else left
    rc = right.combine_chunks() if isinstance(right, pa.ChunkedArray) else right
    combined = pa.chunked_array([lc, rc]).combine_chunks()
    # fast path: integer-typed, no nulls, and a value range small enough that
    # downstream composite packing can't overflow — use shifted values directly
    if pa.types.is_integer(combined.type) and combined.null_count == 0:
        vals = combined.to_numpy(zero_copy_only=False).astype(np.int64)
        lo = int(vals.min()) if len(vals) else 0
        hi = int(vals.max()) if len(vals) else 0
        if hi - lo < (1 << 32):
            codes = vals - lo
            n_left = len(lc)
            return codes[:n_left], codes[n_left:], hi - lo + 1
    dict_arr = pc.dictionary_encode(combined)
    if isinstance(dict_arr, pa.ChunkedArray):
        dict_arr = dict_arr.combine_chunks()
    codes_all = dict_arr.indices
    codes = codes_all.to_numpy(zero_copy_only=False)
    codes = np.where(np.isnan(codes), -1, codes).astype(np.int64) if codes.dtype.kind == "f" else codes.astype(np.int64)
    if codes_all.null_count:
        mask = codes_all.is_valid().to_numpy(zero_copy_only=False)
        codes = np.where(mask, codes, -1)
    n_left = len(lc)
    card = len(dict_arr.dictionary)
    return codes[:n_left], codes[n_left:], card


def _refactorize(
    lcodes: np.ndarray, rcodes: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Re-map arbitrary int64 codes to dense [0, n_distinct) codes, so the
    cardinality is bounded by the total row count (overflow-safe repacking)."""
    combined = np.concatenate([lcodes, rcodes])
    _, dense = np.unique(combined, return_inverse=True)
    dense = dense.astype(np.int64)
    card = int(dense.max()) + 1 if len(dense) else 0
    return dense[: len(lcodes)], dense[len(lcodes):], card


def combined_key_codes(
    left_cols: List[pa.Array], right_cols: List[pa.Array]
) -> Tuple[np.ndarray, np.ndarray]:
    """Reduce (possibly composite) join keys on both sides to single int64
    code arrays; rows with any null key get code -1."""
    assert len(left_cols) == len(right_cols) and left_cols
    lcodes, rcodes, card = _codes_for(left_cols[0], right_cols[0])
    lnull = lcodes < 0
    rnull = rcodes < 0
    for lcol, rcol in zip(left_cols[1:], right_cols[1:]):
        lc2, rc2, card2 = _codes_for(lcol, rcol)
        lnull |= lc2 < 0
        rnull |= rc2 < 0
        if card2 and card > (1 << 62) // max(card2, 1):
            # packing would overflow int64: compress accumulated codes to a
            # dense range first (distinct count <= row count)
            lcodes, rcodes, card = _refactorize(lcodes, rcodes)
        lcodes = lcodes * card2 + np.maximum(lc2, 0)
        rcodes = rcodes * card2 + np.maximum(rc2, 0)
        card = card * card2 if card2 else card
    lcodes = np.where(lnull, -1, lcodes)
    rcodes = np.where(rnull, -1, rcodes)
    return lcodes, rcodes


def join_indices(
    left_codes: np.ndarray, right_codes: np.ndarray, how: str
) -> Tuple[np.ndarray, np.ndarray]:
    """Compute row indices (left_idx, right_idx) realizing the join.

    -1 in either output marks a null-padded side (outer joins). For
    ``semi``/``anti`` only left_idx is meaningful (right_idx empty).
    """
    order = np.argsort(left_codes, kind="stable")
    lsorted = left_codes[order]
    # exclude null build keys from matching by searching only the >=0 region
    first_valid = int(np.searchsorted(lsorted, 0, "left"))
    valid_sorted = lsorted[first_valid:]
    valid_order = order[first_valid:]

    probe_valid = right_codes >= 0
    starts = np.searchsorted(valid_sorted, right_codes, "left")
    ends = np.searchsorted(valid_sorted, right_codes, "right")
    counts = np.where(probe_valid, ends - starts, 0)

    if how == "semi_right":
        keep = counts > 0
        return np.nonzero(keep)[0], np.empty(0, np.int64)
    if how == "anti_right":
        keep = counts == 0
        return np.nonzero(keep)[0], np.empty(0, np.int64)

    total = int(counts.sum())
    probe_idx = np.repeat(np.arange(len(right_codes), dtype=np.int64), counts)
    if total:
        offsets = np.concatenate(([0], np.cumsum(counts)[:-1]))
        flat = (
            np.arange(total, dtype=np.int64)
            - np.repeat(offsets, counts)
            + np.repeat(starts, counts)
        )
        build_idx = valid_order[flat]
    else:
        build_idx = np.empty(0, np.int64)

    if how == "inner":
        return build_idx, probe_idx
    if how == "right":  # keep all probe (right) rows
        unmatched = np.nonzero(counts == 0)[0]
        left_idx = np.concatenate([build_idx, np.full(len(unmatched), -1, np.int64)])
        right_idx = np.concatenate([probe_idx, unmatched.astype(np.int64)])
        return left_idx, right_idx
    if how in ("left", "full"):
        matched_build = np.zeros(len(left_codes), dtype=bool)
        if total:
            matched_build[build_idx] = True
        unmatched_build = np.nonzero(~matched_build)[0]
        left_idx = np.concatenate([build_idx, unmatched_build.astype(np.int64)])
        right_idx = np.concatenate(
            [probe_idx, np.full(len(unmatched_build), -1, np.int64)]
        )
        if how == "full":
            unmatched_probe = np.nonzero(counts == 0)[0]
            left_idx = np.concatenate([left_idx, np.full(len(unmatched_probe), -1, np.int64)])
            right_idx = np.concatenate([right_idx, unmatched_probe.astype(np.int64)])
        return left_idx, right_idx
    if how == "semi":  # left semi: left rows with >=1 match
        matched_build = np.zeros(len(left_codes), dtype=bool)
        if total:
            matched_build[build_idx] = True
        return np.nonzero(matched_build)[0], np.empty(0, np.int64)
    if how == "anti":  # left anti
        matched_build = np.zeros(len(left_codes), dtype=bool)
        if total:
            matched_build[build_idx] = True
        return np.nonzero(~matched_build)[0], np.empty(0, np.int64)
    raise ValueError(f"unknown join type {how!r}")


def take_table(table: pa.Table, indices: np.ndarray) -> pa.Table:
    """Take with -1 meaning null row."""
    if len(indices) and (indices < 0).any():
        idx = pa.array(
            np.where(indices < 0, 0, indices), mask=(indices < 0)
        )
    else:
        idx = pa.array(indices)
    return table.take(idx)
