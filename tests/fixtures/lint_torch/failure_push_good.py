# ballista-lint: path=ballista_tpu_torch/scheduler/fixture_failure_push_good.py
"""GOOD: latency-tier chaos goes through the registered literal
sites — push delivery keyed on the rotated push sequence, AOT loads keyed
on the content-derived program key (a plan coordinate, never a path)."""


def push_deliver(chaos, n):
    return chaos.should_inject("scheduler.push", f"push{n}")


def aot_load(chaos, program_key):
    chaos.maybe_fail("aot.load", f"prog:{program_key[:16]}")
