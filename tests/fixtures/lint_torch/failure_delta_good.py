# ballista-lint: path=ballista_tpu_torch/scheduler/fixture_failure_delta_good.py
"""GOOD: result-cache advancement chaos goes through the
registered literal ``cache.advance`` site, keyed on the advanced entry's
result key — the verdict fires BEFORE any KV write, so a torn publish
leaves no partial entry and the query simply declines to a full recompute
(bit-identical by construction)."""


def publish_advanced(chaos, result_key):
    chaos.maybe_fail("cache.advance", f"fp:{result_key[:16]}")
