# ballista-lint: path=ballista_tpu_torch/scheduler/fixture_failure_spec_good.py
"""GOOD: speculation discipline — the minted duplicate attempt
is recorded in the durable speculation ledger in the same scope, a
promotion lands in the assignment ledger, and the straggler chaos site is
the registered literal `task.slow`."""


def speculate(self, pb, cur, key3, executor_id):
    dup = pb.TaskStatus()
    dup.partition_id.CopyFrom(cur.partition_id)
    dup.attempt = cur.attempt + 1
    dup.speculative = True
    # the durable record restart recovery + first-completion-wins read
    self._spec_put(key3, executor_id, dup.attempt)
    return dup


def promote(self, pb, t, spec, key3):
    promoted = pb.TaskStatus()
    promoted.partition_id.CopyFrom(t.partition_id)
    promoted.attempt = spec[1]
    promoted.speculative = True
    promoted.running.executor_id = spec[0]
    # a promotion enters the normal assignment ledger
    self._ledger_put(key3, spec[0], spec[1])
    return promoted


def echo(td, flag):
    # echo site: copies a non-literal — exempt by design
    td.speculative = flag
    return td


def straggle(chaos, stage_id, partition, attempt):
    return chaos.should_inject(
        "task.slow", f"{stage_id}/{partition}@a{attempt}"
    )
