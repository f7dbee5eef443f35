"""Host operators per query (layer: host operators): the self time of the
program's `op.<class>` spans, each an operator drained by
physical/plan.py::collect_partition (its own host work: the final merge,
host joins, sorts, limits), over the window, per completed query."""

from perfbench.spans import per_query_ms

UNIT = "ms"


def read(run: dict):
    return per_query_ms(run, lambda r: r.name.startswith("op."))
