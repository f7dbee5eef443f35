# ballista-lint: path=ballista_tpu_torch/executor/fixture_failure_fleet_good.py
"""GOOD: disaggregated-shuffle and elastic-fleet chaos goes
through the registered literal sites — the storage publish/read seams keyed
on plan coordinates + attempt (a retried attempt draws fresh), the scale
decision keyed on a per-process evaluation sequence (a torn decision skips
that evaluation; the next draws fresh)."""


def publish_pieces(chaos, stage_id, partition, attempt):
    chaos.maybe_fail("shuffle.store", f"w{stage_id}/{partition}@a{attempt}")


def read_piece(chaos, stage_id, map_partition, piece, attempt):
    return chaos.should_inject(
        "shuffle.store", f"r{stage_id}/{map_partition}/piece{piece}@a{attempt}"
    )


def scale_decision(chaos, seq):
    return chaos.should_inject("fleet.scale", f"scale{seq}")
