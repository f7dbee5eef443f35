# ballista-lint: path=ballista_tpu_torch/ops/fixture_routing_bad.py
"""BAD: decline-helper calls with no routing observation in scope and no
cold-path annotation — the bench routing block would silently undercount
these host decisions."""

from ballista_tpu_torch.ops.kernels import host_fallback, step_aside


def silent_host_decision(reason):
    return host_fallback(reason)


def silent_ladder_step(reason):
    return step_aside(reason)


def foreign_observe_does_not_count(metrics, reason):
    metrics.observe("latency", 1.0)  # not the cost store's observe
    return host_fallback(reason)
