# ballista-lint: path=ballista_tpu_torch/scheduler/fixture_failure_push_bad.py
"""BAD: latency-tier code naming an unregistered push site and
computing the AOT-load site name — both evade the chaos registry."""


def push_deliver(chaos, n):
    # unregistered site: "scheduler.stream" was never added to chaos.SITES
    return chaos.should_inject("scheduler.stream", f"push{n}")


def aot_load(chaos, tier, program_key):
    site = f"{tier}.load"
    # computed site name: the registry cannot see which site this arms
    chaos.maybe_fail(site, f"prog:{program_key[:16]}")
