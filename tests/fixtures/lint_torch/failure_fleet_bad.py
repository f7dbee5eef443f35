# ballista-lint: path=ballista_tpu_torch/executor/fixture_failure_fleet_bad.py
"""BAD: storage/fleet chaos naming an unregistered site and
computing a site name — both evade the chaos registry, so a chaos run could
not be reproduced (or even enumerated) from chaos.SITES."""


def publish_pieces(chaos, stage_id, partition, attempt):
    # unregistered site: "shuffle.publish" was never added to chaos.SITES
    chaos.maybe_fail("shuffle.publish", f"w{stage_id}/{partition}@a{attempt}")


def scale_decision(chaos, direction, seq):
    site = f"fleet.{direction}"
    # computed site name: the registry cannot see which site this arms
    return chaos.should_inject(site, f"scale{seq}")
