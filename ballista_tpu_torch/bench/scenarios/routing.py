"""Adaptive-execution scenario (bench.py `_routing_scenario`): an
in-process join whose build-key multiplicity sits past the static
admission ladder, run on the "cpu" backend, then on the card cold (the
cost model splits at the tier boundary), warm from the persisted store,
and with the cost model off; every run's rows must be identical."""

from __future__ import annotations

import sys
import tempfile

from ballista_tpu_torch.bench import device_arg, snapshots
from ballista_tpu_torch.bench.scenarios import ScenarioFailed
from ballista_tpu_torch.bench.tpch import AnswerMismatch


def _routing_scenario(device=None) -> dict:
    import numpy as np
    import pyarrow as pa

    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine import ExecutionContext
    from ballista_tpu_torch.ops import costmodel
    from ballista_tpu_torch.ops.runtime import routing_stats

    rng = np.random.default_rng(7)
    # one monster key past the top static tier (256) plus a unique tail
    nb = 2000
    bkeys = np.concatenate([np.arange(nb), np.full(400, nb // 2)])
    rng.shuffle(bkeys)
    build = pa.table({"bk": pa.array(bkeys, type=pa.int64()),
                      "bv": pa.array(np.arange(len(bkeys), dtype=np.int64))})
    pkeys = np.concatenate([rng.integers(0, nb + 200, 4000), np.full(3, nb // 2)])
    probe = pa.table({"pk": pa.array(pkeys, type=pa.int64()),
                      "pv": pa.array(np.arange(len(pkeys), dtype=np.int64))})

    def run(backend: str, cm: str, store_dir: str, iters: int = 1):
        ctx = ExecutionContext(BallistaConfig({
            "ballista.executor.backend": backend,
            "ballista.tpu.cost_model": cm,
            "ballista.tpu.cost_model_dir": store_dir,
        }), device="cpu" if backend == "cpu" else device_arg(device))
        ctx.register_record_batches("b", build, n_partitions=1)
        ctx.register_record_batches("p", probe, n_partitions=1)
        df = ctx.table("b").join(ctx.table("p"), ["bk"], ["pk"], how="inner")
        # iters > 1 warms the gather / host cost buckets, so that later
        # decisions carry predictions; every iteration must agree
        outs = [df.collect().to_pylist() for _ in range(iters)]
        if any(o != outs[0] for o in outs[1:]):
            raise AnswerMismatch(f"routing: {backend} runs disagree with each other")
        return outs[0]

    with tempfile.TemporaryDirectory() as tmp:
        costmodel.reset(clear_dir=True)
        routing_stats(reset=True)
        host = run("cpu", "false", "")
        cold = run("cuda", "true", tmp, iters=6)
        costmodel.flush()
        costmodel.reset()  # a fresh process: reload from disk
        warm = run("cuda", "true", tmp, iters=2)
        off = run("cuda", "false", "")
        routing = snapshots._routing_snapshot()
        costmodel.reset()
    if routing is None:
        raise ScenarioFailed("routing: no routing decisions were made")
    routing["bit_identical"] = host == cold == warm == off
    print(f"[routing] engines={routing['engines']} splits={routing['splits']} "
          f"bit_identical={routing['bit_identical']}", file=sys.stderr)
    if not routing["bit_identical"]:
        raise AnswerMismatch("routing: the card's joins differ from the cpu backend's")
    return routing
