# ballista-lint: path=ballista_tpu_torch/executor/fixture_failure_good.py
"""GOOD: fetch_failed carries the lost location; chaos goes through
registered sites only."""


def report_fetch_failure(status, exc, me):
    status.fetch_failed.error = str(exc)
    status.fetch_failed.executor_id = me
    status.fetch_failed.map_stage_id = exc.stage_id
    status.fetch_failed.map_partition_id = exc.map_partition
    status.fetch_failed.map_executor_id = exc.executor_id
    status.fetch_failed.path = exc.path


def poll(chaos, n):
    chaos.maybe_fail("rpc.call", f"poll/{n}")
    return chaos.should_inject("executor.death", f"me/poll{n}")
