"""The port's bench entry leaves no cost observations behind.

The port's cost store (ballista_tpu_torch/ops/costmodel.py) is process-wide.
A bench run warms it (stage rates, join gathers, host joins); once the
bench's sessions end (`bench.tpch.reset_contexts`), the next work in the
same process must find the store as a fresh process would. Otherwise a
warm `join.host` rate left by the bench turns the mesh join's cost-model
admission (parallel/spmd_join.py) to the inline host join.
"""

import pyarrow as pa

import ballista_tpu_torch.config as port_config
from ballista_tpu_torch.bench import data, runner, tpch
from ballista_tpu_torch.ops import costmodel
from test_torch_spmd_join import _dim, _fact, _host_oracle, _plan, _rows

port_config.DEFAULT_SETTINGS[port_config.BALLISTA_TPU_LAYOUT_CACHE_DIR] = ""
port_config.DEFAULT_SETTINGS[port_config.BALLISTA_TPU_COST_MODEL_DIR] = ""

SF = 0.01


def test_bench_sessions_leave_no_cost_observations_for_the_mesh_join(tmp_path, monkeypatch):
    from benchmarks.tpch.datagen import generate

    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    monkeypatch.setattr(data, "CACHE", tmp_path / "cache")
    costmodel.reset()
    # a bench row, then the runner's benchmark of q17 over two partitions a
    # table (its join runs on the host and is observed)
    row = tpch.bench_config(SF, "q5", iters=1)
    assert row["match"] is True
    parts = tmp_path / "parts2"
    generate(str(parts), sf=SF, parts=2)
    runner.main(["benchmark", "--path", str(parts), "--query", "17", "--iterations", "1",
                 "--backend", "cuda"])
    left = costmodel.snapshot()
    assert any(k.startswith("join.gather|") for k in left), left
    assert any(k.startswith("join.host|") for k in left), left
    tpch.reset_contexts()
    assert costmodel.snapshot() == {}
    # the mesh join then admits on its own evidence only: with join.host
    # cold, every run takes the mesh, also once join.mesh is warm
    dim, fact = _dim(100), _fact(400, nk=120)
    want = _rows(_host_oracle(dim, fact, ["dk"], ["fk"], "left"))
    for _ in range(costmodel.MIN_OBSERVATIONS + 1):
        spmd, tctx = _plan(dim, fact, ["dk"], ["fk"], "left", 3, 4, jax_side=False)
        out = pa.Table.from_batches(list(spmd.execute(0, tctx)))
        assert spmd.last_path == "mesh"
        assert _rows(out) == want
    costmodel.reset()
