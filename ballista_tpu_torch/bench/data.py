"""Datasets of the bench, generated once under `.bench_cache/` (bench.py
`data_dir`, `ensure_data`, and the taxi half of `_taxi_rows`)."""

from __future__ import annotations

import os
import pathlib

REPO = pathlib.Path(__file__).resolve().parents[2]
# every dataset lives under this directory: BENCH_CACHE_DIR, else the
# checkout's .bench_cache/ (tests point it at tmp_path)
CACHE = pathlib.Path(os.environ.get("BENCH_CACHE_DIR") or REPO / ".bench_cache")

# BASELINE.md config 4: the group count of the label, the directory
# stem, the zone count (None: the TLC's 265)
TAXI_SHAPES = (
    ("265groups", "taxi", None),
    ("10kgroups", "taxi_hc", 10_000),
)


def data_dir(sf: float) -> pathlib.Path:
    return CACHE / f"tpch_sf{sf}"


def ensure_data(sf: float) -> pathlib.Path:
    from benchmarks.tpch.datagen import generate, is_complete

    d = data_dir(sf)
    if not is_complete(str(d)):
        d.parent.mkdir(parents=True, exist_ok=True)
        generate(str(d), sf=sf, parts=1)
    return d


def ensure_tpch(name: str, sf: float, parts: int) -> pathlib.Path:
    """A scenario's own TPC-H dataset, `CACHE/<name>`."""
    from benchmarks.tpch.datagen import generate, is_complete

    d = CACHE / name
    if not is_complete(str(d)):
        d.parent.mkdir(parents=True, exist_ok=True)
        generate(str(d), sf=sf, parts=parts)
    return d


def taxi_dir(stem: str, sf: float) -> pathlib.Path:
    """The dataset of one taxi shape at `sf` (bench.py's `taxi_sf1` at 1)."""
    return CACHE / f"{stem}_sf{sf:g}"


def ensure_taxi(stem: str, zones: int | None, sf: float = 1.0) -> pathlib.Path:
    """The trips table of one taxi shape (sf 1: 10 M trips); returns its
    directory of Parquet files."""
    from benchmarks.taxi.datagen import generate

    d = taxi_dir(stem, sf)
    if not (d / "trips").exists():
        kw = {"n_zones": zones} if zones else {}
        generate(str(d), sf=sf, parts=1, **kw)
    return d / "trips"
