# ballista-lint: path=ballista_tpu_torch/scheduler/fixture_failure_sched_bad.py
"""BAD: scheduler code naming an unregistered planning site and
computing a scheduler site name — both evade the chaos registry."""


def plan_write(chaos, stage_id, attempt):
    # typo'd/unregistered site: never registered in chaos.SITES
    chaos.maybe_fail("scheduler.plan_commit", f"stage{stage_id}@a{attempt}")


def crash_check(chaos, kind, n):
    site = f"scheduler.{kind}"
    # computed site name: the registry (and seeded-run reproducibility
    # audits) cannot see which site this arms
    return chaos.should_inject(site, f"status{n}")
