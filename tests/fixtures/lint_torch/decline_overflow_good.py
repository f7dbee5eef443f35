# ballista-lint: path=ballista_tpu_torch/ops/fixture_overflow_good.py
"""GOOD: M:N join tier-overflow decline through the canonical helpers —
the admission returns (None, reason), the reason is recorded for bench's
join-path counters (kind "step_aside" keeps the admission-tier
distinction), and host_fallback logs + counts the decline (the join
leaves the device entirely, so tracing counts a fallback)."""

from ballista_tpu_torch.ops.kernels import host_fallback, join_multiplicity_tier
from ballista_tpu_torch.ops.runtime import record_join_path


def join(max_mult, probe_slots):
    tier, why = join_multiplicity_tier(max_mult, probe_slots)
    if tier is None:
        record_join_path("step_aside", why)
        return host_fallback(why)
    return tier
