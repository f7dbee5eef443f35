# ballista-lint: path=ballista_tpu_torch/scheduler/fixture_failure_replica_bad.py
"""BAD: failover chaos naming an unregistered site and computing
a site name — both evade the chaos registry, so a lease-renewal chaos run
could not be reproduced (or even enumerated) from chaos.SITES."""


def renew_round(chaos, generation, renew_seq):
    # unregistered site: "scheduler.renew" was never added to chaos.SITES
    chaos.maybe_fail("scheduler.renew", f"g{generation}/renew{renew_seq}")


def mint_tiered(chaos, kind, generation, lease_seq):
    site = f"{kind}.lease"
    # computed site name: the registry cannot see which site this arms
    chaos.maybe_fail(site, f"g{generation}/lease{lease_seq}")
