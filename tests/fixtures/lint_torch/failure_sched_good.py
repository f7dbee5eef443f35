# ballista-lint: path=ballista_tpu_torch/scheduler/fixture_failure_sched_good.py
"""GOOD: scheduler chaos goes through the registered literal
sites — plan-write tears keyed on plan coordinates + attempt, crash keyed
on the generation-rotated accepted-status sequence."""


def plan_write(chaos, stage_id, partition, attempt):
    chaos.maybe_fail("scheduler.plan_write", f"{stage_id}/{partition}@a{attempt}")


def crash_check(chaos, generation, n):
    return chaos.should_inject("scheduler.crash", f"g{generation}/status{n}")
