# ballista-lint: path=ballista_tpu_torch/scheduler/fixture_failure_tenancy_bad.py
"""BAD: tenancy code naming an unregistered cache site and
computing an admission site name — both evade the chaos registry."""


def cache_put(chaos, fingerprint):
    # unregistered site: "cache.write" was never added to chaos.SITES
    chaos.maybe_fail("cache.write", f"fp:{fingerprint[:16]}")


def admit(chaos, decision, n):
    site = f"scheduler.{decision}"
    # computed site name: the registry cannot see which site this arms
    return chaos.should_inject(site, f"admit{n}")
