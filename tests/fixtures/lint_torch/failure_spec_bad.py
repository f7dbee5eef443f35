# ballista-lint: path=ballista_tpu_torch/scheduler/fixture_failure_spec_bad.py
"""BAD: an ad-hoc second-attempt path — the duplicate is minted
(`speculative = True`) and dispatched with NO durable ledger record, so a
scheduler restart forgets it and first-completion-wins bookkeeping never
sees the pair; plus an unregistered straggler chaos site."""


def speculate(self, pb, cur, executor_id):
    dup = pb.TaskStatus()
    dup.partition_id.CopyFrom(cur.partition_id)
    dup.attempt = cur.attempt + 1
    dup.speculative = True
    # no _spec_put / _ledger_put: invisible to restart recovery
    self._dispatch(executor_id, dup)
    return dup


def straggle(chaos, stage_id, partition, attempt):
    # never registered in chaos.SITES
    return chaos.should_inject(
        "task.straggle", f"{stage_id}/{partition}@a{attempt}"
    )
