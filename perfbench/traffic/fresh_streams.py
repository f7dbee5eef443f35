"""TPC-H's throughput test as closed loops: `streams` concurrent clients,
each running the templates in its own seeded order, and every query with
fresh parameters. The parameters of a template are drawn without
replacement across all streams of a run: stream s takes the s-th, the
(s + streams)-th, ... of the template's seeded permutation, so the streams'
shares are disjoint, and a stream cycles through its share only once it
has used the share up. Set-up runs each template once with
TPC-H's validation parameters, which the window's draws leave out.
Parameters of the cell file: `streams`, the number of streams (required)."""

from __future__ import annotations

import numpy as np

LENGTH = 5000  # queries listed per stream, more than any window completes


def make(spec: dict, templates: list, rng: np.random.Generator):
    """(set-up queries, the queries of each stream in order)."""
    n = int(spec["streams"])
    warmup = [t.query(t.params.VALIDATION) for t in templates]
    pools = {}
    for t in templates:
        space = [p for p in t.params.space() if p != t.params.VALIDATION]
        pools[t.name] = [space[i] for i in rng.permutation(len(space))]
    streams = []
    for s in range(n):
        order = rng.permutation(len(templates))
        uses = dict.fromkeys(pools, 0)
        queries = []
        for j in range(LENGTH):
            t = templates[order[j % len(order)]]
            share = pools[t.name][s::n]
            queries.append(t.query(share[uses[t.name] % len(share)]))
            uses[t.name] += 1
        streams.append(queries)
    return warmup, streams
