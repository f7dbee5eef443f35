"""A graceful scale-in charges no task retry (ROADMAP §3, F11).

`StandaloneCluster.scale_in_one` drains the newest executor: it cancels
its push stream, finishes and reports its tasks, and stops. The scheduler
learns of the cancel only when its stream generator next looks, so its
pump may still push tasks into the closing stream, and the cancel drops
what the executor had not read. The port's scheduler takes such tasks
back with no retry, before the dead-executor reaper (F8) or the lease can
count them lost: those still queued when the stream closes, at the same
attempt (`SchedulerServer._withdraw_unsent_locked`), and, on a poll that
says the executor drains, every other one it does not echo, past its
attempt (`_retire_pushes_locked`), since it may have read it after all.
An executor stopped without a drain says nothing, so what it was sent is
still reset as lost, with a retry.

- the deterministic cases: a push subscription whose call is already
  cancelled leaves its queued tasks pending; one whose call is cancelled
  just after one or two tasks went out, by an executor that then polls
  as draining, puts those back past their attempt, and the retired
  executor's late reports of them are dropped as stale; neither charges a
  retry. One whose executor stops without a drain has the task it was
  sent reset with a retry. Each job still answers as the fixed cluster
  does;
- the repeated case: the fleet grows under bursts and drains back again,
  round after round, with zero retries and every answer equal.
"""

import logging
import socket
import time

import numpy as np
import pyarrow as pa
import pytest

import ballista_tpu_torch.config as port_config
from ballista_tpu_torch.client import BallistaContext
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.executor.runtime import StandaloneCluster
from ballista_tpu_torch.ops.runtime import fleet_stats, recovery_stats, serving_stats
from ballista_tpu_torch.proto import ballista_pb2 as pb
from ballista_tpu_torch.scheduler.rpc import DRAINING_METADATA

port_config.DEFAULT_SETTINGS[port_config.BALLISTA_TPU_LAYOUT_CACHE_DIR] = ""
port_config.DEFAULT_SETTINGS[port_config.BALLISTA_TPU_COST_MODEL_DIR] = ""
logging.getLogger("ballista").setLevel(logging.CRITICAL)

SQL = "select g, sum(v) as s, count(*) as c from t group by g order by g"
FLEET = {"ballista.fleet.min": "1", "ballista.fleet.max": "3",
         "ballista.fleet.interval_s": "0.1", "ballista.fleet.target_backlog_s": "0.05"}


def _table(n=20_000, seed=5):
    rng = np.random.default_rng(seed)
    return pa.table({
        "g": pa.array(rng.integers(0, 9, n), type=pa.int64()),
        "v": pa.array(rng.integers(-100, 100, n), type=pa.int64()),
    })


def _client(cluster, store):
    return BallistaContext(*cluster.scheduler_addr, device="cpu", settings={
        "ballista.shuffle.tier": "shared", "ballista.shuffle.dir": str(store),
        "ballista.shuffle.partitions": "8", "ballista.cache.results": "false"})


def _wait(pred, timeout):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


def _job_states(ctx, jobs):
    return [ctx._client.get_job_status(pb.GetJobStatusParams(job_id=j))
            .status.WhichOneof("status") for j in jobs]


class _Call:
    """The server side of a call; `active = False` is the executor's
    cancel, `metadata` what the executor sent with the call."""

    def __init__(self, active, metadata=()):
        self.active = active
        self.metadata = metadata

    def is_active(self):
        return self.active

    def invocation_metadata(self):
        return self.metadata


def _closed_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("sent,drains", [(0, False), (1, True), (2, True), (1, False)],
                         ids=["queued", "delivered_then_cancelled",
                              "two_delivered_then_cancelled", "delivered_then_stopped"])
def test_push_into_a_cancelled_stream_goes_back_to_pending(tmp_path, sent, drains):
    table = _table()
    fixed = StandaloneCluster(n_executors=1, device="cpu")
    try:
        ctx = _client(fixed, tmp_path / "ref")
        ctx.register_record_batches("t", table, n_partitions=8)
        ref = ctx.sql(SQL).collect()
        ctx.close()
    finally:
        fixed.shutdown()

    cluster = StandaloneCluster(n_executors=0, device="cpu")
    # a draining executor's Flight port still accepts connections; a
    # retired or stopped one's refuses them
    flight = socket.socket()
    flight.bind(("127.0.0.1", 0))
    if drains:
        flight.listen()
    port = flight.getsockname()[1]
    if not drains:
        flight.close()
    try:
        server, state = cluster.scheduler_impl, cluster.scheduler_impl.state
        ctx = _client(cluster, tmp_path / "store")
        ctx.register_record_batches("t", table, n_partitions=8)
        job = ctx.submit(ctx.sql(SQL).logical_plan())
        assert _wait(lambda: len(state.get_all_tasks()) > 0, 30.0)
        recovery_stats(reset=True)
        serving_stats(reset=True)
        params = pb.SubscribeWorkParams(slots=4)
        params.metadata.id = "retiring"
        params.metadata.host = "127.0.0.1"
        params.metadata.port = port
        call = _Call(active=bool(sent))
        stream = server.SubscribeWork(params, context=call)
        with state.kv.lock():
            pushed = [t for t in state.get_all_tasks() if t.WhichOneof("status") == "running"]
        assert len(pushed) == 4, [t.WhichOneof("status") for t in state.get_all_tasks()]
        # the transport sends `sent` tasks, then finds the call cancelled
        # and stops without asking the stream for the next
        delivered = [next(stream) for _ in range(sent)]
        call.active = False
        assert list(stream) == []
        if drains:
            # the draining executor's next heartbeat echoes nothing: it
            # read none of what was sent before its cancel
            server.PollWork(pb.PollWorkParams(metadata=params.metadata),
                            context=_Call(True, (DRAINING_METADATA,)))
        else:
            # the dead-executor reaper finds the port closed
            assert _wait(lambda: state.get_executor_metadata("retiring") is None, 10.0)
        with state.kv.lock():
            after = {(t.partition_id.stage_id, t.partition_id.partition_id): t
                     for t in state.get_all_tasks()}
        went_out = {(d.task_id.stage_id, d.task_id.partition_id) for d in delivered}
        for t in pushed:
            key = (t.partition_id.stage_id, t.partition_id.partition_id)
            back = after[key]
            assert back.WhichOneof("status") is None, back
            assert back.attempt == t.attempt + (key in went_out), back
            assert len(back.history) == (key in went_out and not drains), back
        assert serving_stats(reset=True).get("push_withdrawn") == 4 - sent * (not drains)
        for d in delivered:
            # the retired executor ran what it was sent; its report is stale
            late = pb.TaskStatus(attempt=d.attempt)
            late.partition_id.CopyFrom(d.task_id)
            late.completed.executor_id = "retiring"
            with state.kv.lock():
                assert not state.accept_task_status(late)
        flight.close()
        cluster._spawn_executor()
        assert _wait(lambda: _job_states(ctx, [job]) == ["completed"], 60.0)
        assert ctx._collect_results(job, ref.schema).equals(ref)
        ctx.close()
    finally:
        flight.close()
        cluster.shutdown()
    rec = recovery_stats(reset=True)
    lost = sent * (not drains)
    assert rec.get("task_retry", 0) == lost and rec.get("lost_task_reset", 0) == lost, rec
    assert rec.get("stale_status_dropped", 0) == sent, rec


def test_repeated_scale_in_charges_no_retry(tmp_path):
    table = _table()
    rounds = 6
    fleet_stats(reset=True)
    recovery_stats(reset=True)
    cluster = StandaloneCluster(config=BallistaConfig(FLEET), n_executors=1, device="cpu")
    try:
        ctx = _client(cluster, tmp_path / "store")
        ctx.register_record_batches("t", table, n_partitions=8)
        ref = ctx.sql(SQL).collect()
        peaks = []
        for _ in range(rounds):
            jobs = [ctx.submit(ctx.sql(SQL).logical_plan()) for _ in range(4)]
            peak = cluster.fleet_size()

            def done():
                nonlocal peak
                peak = max(peak, cluster.fleet_size())
                return all(s in ("completed", "failed") for s in _job_states(ctx, jobs))

            assert _wait(done, 60.0)
            assert _job_states(ctx, jobs) == ["completed"] * len(jobs)
            for j in jobs:
                assert ctx._collect_results(j, ref.schema).equals(ref), j
            assert _wait(lambda: cluster.fleet_size() == 1, 30.0)
            peaks.append(peak)
        ctx.close()
    finally:
        cluster.shutdown()
    fleet = fleet_stats(reset=True)
    rec = recovery_stats(reset=True)
    assert max(peaks) > 1, peaks
    assert fleet.get("scale_down", 0) >= 1, fleet
    assert fleet.get("drain_completed", 0) >= fleet.get("scale_down", 0), fleet
    assert rec.get("task_retry", 0) == 0 and rec.get("lost_task_reset", 0) == 0, rec
