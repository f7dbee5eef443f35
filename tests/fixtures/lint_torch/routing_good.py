# ballista-lint: path=ballista_tpu_torch/ops/fixture_routing_good.py
"""GOOD: every decline-helper call is paired with a routing observation
(or carries a reviewed cold-path annotation)."""

from ballista_tpu_torch.ops import costmodel
from ballista_tpu_torch.ops.kernels import host_fallback, step_aside
from ballista_tpu_torch.ops.runtime import (
    record_join_path,
    record_routing,
    record_routing_event,
)


def declined_with_decision(reason):
    record_routing("host", "fixture")
    return host_fallback(reason)


def declined_with_event(reason):
    record_routing_event("fixture.step_aside")
    return step_aside(reason)


def declined_with_join_counter(reason):
    record_join_path("host_fallback", reason)
    return host_fallback(reason)


def declined_with_cost_observation(reason):
    costmodel.observe("fixture.host", 10, 0.1, engine="host")
    return host_fallback(reason)


def compile_time_check(ok):
    if not ok:
        # cold-path: compile-time probe; the consumer records the decision
        return host_fallback("fixture compile probe")
    return ok
