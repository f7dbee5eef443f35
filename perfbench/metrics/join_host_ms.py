"""The device join's host side per query (layer: device join host side):
the self time of the spans factagg.rank_search, factagg.dim_side,
factagg.secondary_side, mappedscan.dim_maps, join.gather and join.flatten
over the window, per completed query."""

from perfbench.spans import per_query_ms

UNIT = "ms"
NAMES = ("factagg.rank_search", "factagg.dim_side", "factagg.secondary_side",
         "mappedscan.dim_maps", "join.gather", "join.flatten")


def read(run: dict):
    return per_query_ms(run, lambda r: r.name in NAMES)
