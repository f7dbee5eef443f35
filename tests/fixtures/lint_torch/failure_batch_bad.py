# ballista-lint: path=ballista_tpu_torch/scheduler/fixture_failure_batch_bad.py
"""BAD: batching code naming an unregistered grouping site and
computing the site name — both evade the chaos registry."""


def form_batch(chaos, generation, seq):
    # unregistered site: "scheduler.group" was never added to chaos.SITES
    chaos.maybe_fail("scheduler.group", f"g{generation}/batch{seq}")


def form_batch_computed(chaos, tier, seq):
    site = f"{tier}.batch"
    # computed site name: the registry cannot see which site this arms
    chaos.maybe_fail(site, f"batch{seq}")
