# ballista-lint: path=ballista_tpu_torch/scheduler/fixture_failure_delta_bad.py
"""BAD: advancement chaos naming an unregistered site and
computing a site name — both evade the chaos registry, so a cache.advance
chaos run could not be reproduced (or even enumerated) from chaos.SITES."""


def publish_advanced(chaos, result_key):
    # unregistered site: "cache.fold" was never added to chaos.SITES
    chaos.maybe_fail("cache.fold", f"fp:{result_key[:16]}")


def publish_tiered(chaos, tier, result_key):
    site = f"cache.{tier}"
    # computed site name: the registry cannot see which site this arms
    chaos.maybe_fail(site, f"fp:{result_key[:16]}")
