"""TPC-H's power test as a closed loop: one stream runs the templates in a
seeded order, each template with its own seeded parameters, and repeats
that round. Set-up runs the round once (cold), so the window measures
the warm path."""

from __future__ import annotations

import numpy as np

ROUNDS = 5000  # more than any window completes


def make(spec: dict, templates: list, rng: np.random.Generator):
    """(set-up queries, the queries of the one stream in order)."""
    round_ = []
    for i in rng.permutation(len(templates)):
        space = templates[i].params.space()
        round_.append(templates[i].query(space[rng.integers(len(space))]))
    return round_, [round_ * ROUNDS]
