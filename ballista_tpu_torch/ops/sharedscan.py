"""Shared-scan multi-query execution: the scheduler's half only.

The scheduler groups compatible co-pending stage tasks of different jobs
into one batched dispatch (scheduler/state.py form_shared_batch); its
signature and the executor's check must find the same aggregate, and
_find_aggregate is that one walk. The executor's half, `precompute` with
the combined one-launch step over one shared upload, is not ported yet
(ROADMAP item 3): the executor runs every member of a batch solo
(executor/execution_loop.py), which gives each member the answer its own
task would.
"""

from __future__ import annotations


def _find_aggregate(plan):
    """The batchable aggregate node under a stage plan: the FIRST
    HashAggregateExec down the single-child operator spine (stage plans put
    sort/projection/coalesce epilogues ABOVE the aggregate; they consume
    its output per member and never affect what the aggregate computes).
    None when the spine forks or ends before an aggregate, or the mode is
    FINAL (final aggregates read shuffles, not scans)."""
    from ballista_tpu_torch.physical.aggregate import AggregateMode, HashAggregateExec

    node = plan
    while not isinstance(node, HashAggregateExec):
        kids = node.children()
        if len(kids) != 1:
            return None
        node = kids[0]
    if node.mode in (AggregateMode.PARTIAL, AggregateMode.SINGLE):
        return node
    return None
