"""Prepared stage state carried across from the JAX reference package.

For this system, data takes the place of weights: both packages read the
same Parquet files. The state that has to cross is a fused stage's prepared
partition — the host-ranked, narrowed, padded columns a device step runs
over. ``prepared_from_reference`` turns a JAX stage's
``_device_cache[partition]`` entry, converted to numpy by the caller, into
this package's entry on a torch device, so the port's device step can run
on exactly the state the reference prepared:

    {"kind": "batches", "entries": [{"n_groups", "seg_bucket",
        "cols": {idx: array | (codes, lut)}, "codes", "row_valid",
        "key_values"}, ...]}
    {"kind": "sorted", "layout", "cols": {idx: [V, L1] tiles | (tiles, lut)},
        "clen", "key_values", "n_groups", "derived": {name: [V, L1] tiles}}
        plus, for a fact-aggregate stage's entry (ops/factagg.py),
        "rank_keys" and "rank_order" (host arrays)
    {"kind": "pallas_sorted", "codes", "cols", "row_valid", "key_values",
        "n_groups"}
    {"kind": "empty"}

Arrays become tensors on `device`; (codes, lut) pairs stay pairs (the LUT
encoding widen_cols understands); Arrow key values and counts pass through.
A "sorted" entry's layout is rebuilt with SortedSegmentLayout.from_state
from what the reference layout exposes (``state()``, ``owner``, ``clen``),
so no object of the reference package crosses. A fact-aggregate stage's
entry (the JAX FactAggregateStage's ``_prepared[partition]``) carries its
derived tiles (q5's per-row secondary attribute) and its rank keys too, so
the port's fact steps can run on what the reference prepared. String
predicates compare dictionary codes, so a stage whose filters test
strings needs the reference stage's dictionaries too; this helper carries
only the prepared entry.
"""

from __future__ import annotations

import numpy as np

from ballista_tpu_torch.ops.layout import SortedSegmentLayout
from ballista_tpu_torch.ops.runtime import upload

_KINDS = ("batches", "sorted", "pallas_sorted", "empty")


def _tensors(cols: dict, device) -> dict:
    out = {}
    for idx, v in cols.items():
        if isinstance(v, tuple):
            codes, lut = v
            out[idx] = (upload(np.asarray(codes), device), upload(np.asarray(lut), device))
        else:
            out[idx] = upload(np.asarray(v), device)
    return out


def prepared_from_reference(entry: dict, device) -> dict:
    """The JAX package's prepared entry (numpy arrays) -> this package's
    entry with tensors on `device`."""
    kind = entry.get("kind")
    if kind not in _KINDS:
        raise ValueError(f"cannot carry a prepared entry of kind {kind!r}")
    if kind == "empty":
        return {"kind": "empty"}
    if kind == "sorted":
        ref = entry["layout"]
        layout = SortedSegmentLayout.from_state(
            ref.state(), np.asarray(ref.owner), np.asarray(ref.clen)
        )
        derived = entry.get("derived") or {}
        for name, tiles in derived.items():
            # derived tiles ride the layout's [V, L1] grid, like the columns
            if np.shape(tiles) != (layout.V, layout.L1):
                raise ValueError(
                    f"derived tiles {name!r} of shape {np.shape(tiles)} do not "
                    f"match the layout's [{layout.V}, {layout.L1}]"
                )
        out = {
            "kind": kind,
            "layout": layout,
            "cols": _tensors(entry["cols"], device),
            "clen": upload(layout.clen, device),
            "key_values": entry["key_values"],
            "n_groups": int(entry["n_groups"]),
            "derived": _tensors(derived, device),
        }
        for name in ("rank_keys", "rank_order"):
            if name in entry:
                out[name] = np.asarray(entry[name])
        if "rank_keys" in entry:
            from ballista_tpu_torch.ops.factagg import int64_keys

            keys64 = int64_keys(out["rank_keys"])
            if keys64 is not None:
                out["rank_keys_dev"] = upload(keys64, device)
        return out
    if kind == "pallas_sorted":
        return {
            "kind": kind,
            "codes": upload(np.asarray(entry["codes"], dtype=np.int32), device),
            "cols": _tensors(entry["cols"], device),
            "row_valid": upload(np.asarray(entry["row_valid"], dtype=np.bool_), device),
            "key_values": entry["key_values"],
            "n_groups": int(entry["n_groups"]),
        }
    return {
        "kind": kind,
        "entries": [
            {
                "n_groups": int(e["n_groups"]),
                "seg_bucket": int(e["seg_bucket"]),
                "cols": _tensors(e["cols"], device),
                "codes": upload(np.asarray(e["codes"]), device),
                "row_valid": upload(np.asarray(e["row_valid"], dtype=np.bool_), device),
                "key_values": e["key_values"],
            }
            for e in entry["entries"]
        ],
    }
