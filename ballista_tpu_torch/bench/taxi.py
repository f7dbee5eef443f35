"""The NYC-taxi rows (bench.py `_taxi_rows`, BASELINE.md config 4): the
trip aggregation over 10 M trips, grouped by 265 zones and by 10,000."""

from __future__ import annotations

from ballista_tpu_torch.bench import data, tpch


def trips_label(sf: float) -> str:
    """The trip count of a taxi dataset at `sf`, as its row names it
    ("10M" at sf 1, as in bench.py; "100k" at sf 0.01)."""
    n = max(1, int(10_000_000 * sf))
    for unit, size in (("M", 1_000_000), ("k", 1_000)):
        if n % size == 0:
            return f"{n // size}{unit}"
    return str(n)


def _taxi_rows(device=None, sf: float = 1.0) -> list:
    """Both taxi rows at `sf` (1: bench.py's 10 M trips; tests pass less)."""
    from benchmarks.taxi.datagen import TRIP_AGG_QUERY

    out = []
    for groups, stem, zones in data.TAXI_SHAPES:
        table = "trips" if zones is None else "trips_hc"
        sql = TRIP_AGG_QUERY.replace("from trips", f"from {table}")

        def ready(stem=stem, zones=zones, table=table):
            trips = data.ensure_taxi(stem, zones, sf)
            for backend in ("cuda", "cpu"):
                ctx = tpch._context(backend, None, device)
                if table not in ctx.tables:
                    ctx.register_parquet(table, str(trips))

        label = f"taxi_{trips_label(sf)}_{groups}"
        out.append(tpch.measure(label, sf, sql, 2, device, data_ready=ready))
    return out
