"""The port's multi-process mesh stage (ballista_tpu_torch/parallel/multihost.py
and SpmdAggregateExec's multi-process path) on torch.distributed: two
processes of four CPU shards each, joined over gloo.

Each process is this file run as a script (the __main__ block below): it
initializes the process group itself (address, world size, rank, as the
caller must), plans the query through the port's DistributedPlanner under
ballista.tpu.spmd_stages with ballista.tpu.mesh "data:8", executes the fused
stage over its four local shards, and writes one JSON line: its path, the
scan partitions it read and the answer. Each subprocess has its own
timeout, so a hang fails this test and not the suite.

The answers must agree between the processes, cover every partition once
(partition p belongs to shard p % 8: shards 0-3 on rank 0), equal the
one-process port mesh of 8 shards and the JAX package's one-process mesh on
its 8 forced devices (the mesh the JAX package's tests/test_multihost.py
holds its two-process run to), and the pyarrow oracle: keys, counts and
integer sums exactly, f32 sums within rtol 1e-4 (tests/test_multihost.py),
at high cardinality rtol 1e-4 / atol 2e-3. String keys decline on both
processes together (collective agreement) and are answered on the host.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

N_PARTS = 8
QUERIES = {"int_keys": "k", "highcard": "hk", "string_keys": "s"}
WORKER_TIMEOUT_S = 150


def _dataset(d, seed=5):
    rng = np.random.default_rng(seed)
    d.mkdir()
    tables = []
    for p in range(N_PARTS):
        n = 4000 + p * 111  # uneven partitions
        t = pa.table({
            "k": pa.array(rng.integers(0, 40, n), type=pa.int64()),
            "hk": pa.array(rng.integers(0, 5000, n), type=pa.int64()),
            "s": pa.array([f"s{i % 6}" for i in range(n)]),
            "v": pa.array(rng.uniform(-10, 10, n)),
            "w": pa.array(rng.integers(-100, 100, n), type=pa.int64()),
        })
        pq.write_table(t, str(d / f"part-{p}.parquet"))
        tables.append(t)
    return pa.concat_tables(tables)


def _aggs(col, F):
    return [F.sum(col("v")).alias("sv"), F.count(col("v")).alias("c"),
            F.min(col("v")).alias("mn"), F.sum(col("w")).alias("sw")]


def _find(node, cls):
    if isinstance(node, cls):
        return node
    for c in node.children():
        r = _find(c, cls)
        if r is not None:
            return r
    return None


def _port_spmd(data_dir, key, devices):
    """(fused stage, task context) of the query in the port, on `devices`."""
    import torch

    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.distributed.planner import DistributedPlanner
    from ballista_tpu_torch.engine import ExecutionContext
    from ballista_tpu_torch.logical import col, functions as F
    from ballista_tpu_torch.parallel.spmd_stage import SpmdAggregateExec
    from ballista_tpu_torch.physical.plan import TaskContext

    cfg = BallistaConfig({"ballista.executor.backend": "cuda", "ballista.tpu.spmd_stages": "true",
                          "ballista.tpu.mesh": "data:8", "ballista.tpu.layout_cache_dir": "",
                          "ballista.tpu.cost_model_dir": ""})
    ctx = ExecutionContext(cfg, device="cpu")
    ctx.register_parquet("t", str(data_dir))
    df = ctx.table("t").aggregate([col(key)], _aggs(col, F))
    stages = DistributedPlanner(cfg).plan_query_stages("mh", ctx.create_physical_plan(
        df.logical_plan()))
    spmd = next(s for s in (_find(st, SpmdAggregateExec) for st in stages) if s is not None)
    return spmd, TaskContext(config=cfg, work_dir=str(data_dir), job_id="mh",
                             device=torch.device("cpu"), mesh_devices=devices)


def _answer(table, key):
    t = table.sort_by(key)
    return {k: t.column(k).to_pylist() for k in t.schema.names}


def _worker(rank: int, world: int, port: int, data_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from ballista_tpu_torch.ops.stage import FusedAggregateStage

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    read = []
    orig = FusedAggregateStage._scan_batches

    def tracking(self, partition, ctx):
        read.append(partition)
        return orig(self, partition, ctx)

    FusedAggregateStage._scan_batches = tracking
    out = {}
    try:
        for name, key in QUERIES.items():
            read.clear()
            spmd, tctx = _port_spmd(data_dir, key, [torch.device("cpu")] * 4)
            table = pa.Table.from_batches(list(spmd.execute(0, tctx)), schema=spmd.schema())
            out[name] = {"path": spmd.last_path, "read": sorted(set(read)),
                         "result": _answer(table, key)}
    finally:
        dist.destroy_process_group()
    print(json.dumps({"rank": rank, "queries": out}))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_mesh_answer(data_dir, key):
    from ballista_tpu.config import BallistaConfig
    from ballista_tpu.distributed.planner import DistributedPlanner
    from ballista_tpu.engine import ExecutionContext
    from ballista_tpu.logical import col, functions as F
    from ballista_tpu.parallel.spmd_stage import SpmdAggregateExec
    from ballista_tpu.physical.plan import TaskContext

    cfg = BallistaConfig({"ballista.executor.backend": "tpu", "ballista.tpu.spmd_stages": "true",
                          "ballista.tpu.mesh": "data:8"})
    ctx = ExecutionContext(cfg)
    ctx.register_parquet("t", str(data_dir))
    df = ctx.table("t").aggregate([col(key)], _aggs(col, F))
    stages = DistributedPlanner(cfg).plan_query_stages("mh", ctx.create_physical_plan(
        df.logical_plan()))
    spmd = next(s for s in (_find(st, SpmdAggregateExec) for st in stages) if s is not None)
    table = pa.Table.from_batches(list(spmd.execute(0, TaskContext(config=cfg))))
    assert spmd.last_path == "mesh"
    return _answer(table, key)


def _same(got, want, key, highcard):
    for k in (key, "c", "sw"):
        assert got[k] == want[k], k
    tol = dict(rtol=1e-4, atol=2e-3) if highcard else dict(rtol=1e-4)
    np.testing.assert_allclose(got["sv"], want["sv"], **tol)
    np.testing.assert_allclose(got["mn"], want["mn"], rtol=1e-6)


def test_two_processes_over_gloo_match_one_process(tmp_path):
    import torch

    data_dir = tmp_path / "t"
    full = _dataset(data_dir)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS",)}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    for rank in range(2):
        fo = open(tmp_path / f"out{rank}", "w")
        fe = open(tmp_path / f"err{rank}", "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(rank), "2", str(port), str(data_dir)],
            stdout=fo, stderr=fe, env=env, cwd=root), fo, fe))
    outs = []
    try:
        # the one-process answers while the workers run: the one-process port
        # mesh of 8 shards and the JAX package's mesh (integer-like keys)
        local = {}
        for name, key in QUERIES.items():
            spmd, tctx = _port_spmd(data_dir, key, [torch.device("cpu")] * 8)
            local[name] = (_answer(pa.Table.from_batches(list(spmd.execute(0, tctx)),
                                                         schema=spmd.schema()), key),
                           spmd.last_path,
                           None if name == "string_keys" else _jax_mesh_answer(data_dir, key))
        for rank, (p, fo, fe) in enumerate(procs):
            rc = p.wait(timeout=WORKER_TIMEOUT_S)
            fo.close()
            fe.close()
            err = (tmp_path / f"err{rank}").read_text()
            assert rc == 0, f"worker {rank} failed:\n{err[-3000:]}"
            outs.append(json.loads((tmp_path / f"out{rank}").read_text().strip().splitlines()[-1]))
    finally:
        for p, fo, fe in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    for name, key in QUERIES.items():
        r0, r1 = outs[0]["queries"][name], outs[1]["queries"][name]
        assert r0["result"] == r1["result"], name
        want_path = "host" if name == "string_keys" else "mesh"
        assert (r0["path"], r1["path"]) == (want_path, want_path), name
        if want_path == "mesh":
            # each process read only its own shards' partitions, together all
            assert set(r0["read"]) == {p for p in range(N_PARTS) if p % 8 < 4}
            assert set(r0["read"]).isdisjoint(r1["read"])
            assert set(r0["read"]) | set(r1["read"]) == set(range(N_PARTS))
        got = r0["result"]
        highcard = name == "highcard"
        if highcard:
            assert len(got[key]) > 1024, "not a sorted-path cardinality"
        one, one_path, jax_answer = local[name]
        assert one_path == "mesh"
        _same(got, one, key, highcard)
        if jax_answer is not None:
            _same(got, jax_answer, key, highcard)
        g = full.group_by(key).aggregate([("v", "sum"), ("v", "count"), ("w", "sum")]).sort_by(key)
        assert got[key] == g.column(key).to_pylist()
        assert got["c"] == g.column("v_count").to_pylist()
        assert got["sw"] == g.column("w_sum").to_pylist()


def test_single_process_helpers_return_local_values():
    from ballista_tpu_torch.parallel import multihost as mh
    from ballista_tpu_torch.parallel.mesh import build_mesh
    import torch

    mesh = build_mesh({"data": 4}, [torch.device("cpu")] * 4)
    assert mh.process_count() == 1 and mh.local_shard_ids(mesh) == [0, 1, 2, 3]
    assert mh.owned_partitions(6, mesh) == list(range(6))
    assert [mh.partition_shard(p, 8) for p in range(10)] == [0, 1, 2, 3, 4, 5, 6, 7, 0, 1]
    assert mh.allgather_rows(np.array([True, False])).tolist() == [1, 0]
    assert mh.agree(True) and not mh.agree(False) and mh.global_max(7) == 7
    blocks = mh.make_sharded(mesh, {i: np.full(2, i) for i in range(4)}, 8, np.int32)
    assert [b.tolist() for b in blocks.values()] == [[0, 0], [1, 1], [2, 2], [3, 3]]


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
