# ballista-lint: path=ballista_tpu_torch/scheduler/fixture_failure_replica_good.py
"""GOOD: replica-failover chaos goes through the registered
literal sites. ``scheduler.lease`` (keyed generation/renewal-round) tears a
housekeeping renewal round BEFORE any lease write, so the owned leases
simply lapse one TTL early and a peer adopts; ``kv.lease`` (keyed
generation/mint-sequence) tears a lease mint BEFORE the planning commit it
rides, so the whole batch declines atomically."""


def renew_round(chaos, generation, renew_seq):
    chaos.maybe_fail("scheduler.lease", f"g{generation}/renew{renew_seq}")


def mint_lease(chaos, generation, lease_seq):
    chaos.maybe_fail("kv.lease", f"g{generation}/lease{lease_seq}")
