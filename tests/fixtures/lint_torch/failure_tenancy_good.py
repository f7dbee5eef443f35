# ballista-lint: path=ballista_tpu_torch/scheduler/fixture_failure_tenancy_good.py
"""GOOD: multi-tenant serving chaos goes through the registered
literal sites — result-cache puts keyed on the content-derived fingerprint
(a plan coordinate), admission keyed on the rotated admission sequence."""


def cache_put(chaos, fingerprint):
    chaos.maybe_fail("cache.put", f"fp:{fingerprint[:16]}")


def admit(chaos, n):
    chaos.maybe_fail("scheduler.admit", f"admit{n}")
