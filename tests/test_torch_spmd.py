"""The port's mesh and its demo programs (ballista_tpu_torch/parallel/mesh.py,
spmd.py) against the JAX package's on its 8 forced CPU devices.

The port's mesh is a repeated CPU device list of the same size. The three
demos (build_q1_style_step over build_psum_aggregate, and
build_all_to_all_exchange_aggregate) take the same inputs, made from a seed
with numpy, and agree with the JAX package within f32 tolerance (rtol 2e-5,
test_tpu_backend.py:41); counts are exact. The in-process collectives fold
in shard order, pmin / pmax through the floats' order-preserving keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ballista_tpu.parallel.mesh import build_mesh as jax_build_mesh
from ballista_tpu_torch.parallel import mesh as port_mesh
from ballista_tpu_torch.parallel import spmd as port_spmd

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 forced CPU devices of tests/conftest.py")
    return jax_build_mesh({"data": 8}), port_mesh.build_mesh({"data": 8}, CPU8)


def test_q1_style_step_matches_jax(meshes):
    from ballista_tpu.parallel.spmd import build_q1_style_step as jax_step

    jm, tm = meshes
    rng = np.random.default_rng(0)
    N, G = 4096, 6
    arrays = (
        rng.integers(0, G, N).astype(np.int32),
        rng.uniform(1, 50, N).astype(np.float32),
        rng.uniform(900, 10_000, N).astype(np.float32),
        rng.uniform(0, 0.1, N).astype(np.float32),
        rng.uniform(0, 0.08, N).astype(np.float32),
        rng.integers(8000, 10_500, N).astype(np.int32),
    )
    want = np.asarray(jax_step(jm, G, cutoff_days=10_000)(*(jnp.asarray(a) for a in arrays)))
    got = port_spmd.build_q1_style_step(tm, G, cutoff_days=10_000)(*arrays).numpy()
    assert got.shape == want.shape == (6, G)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got, want, rtol=2e-5)


def test_all_to_all_exchange_matches_jax(meshes):
    from ballista_tpu.parallel.spmd import build_all_to_all_exchange_aggregate as jax_ex

    jm, tm = meshes
    rng = np.random.default_rng(1)
    N, K = 4096, 64  # 64 keys over 8 shards: 8 groups per shard
    keys = rng.integers(0, K, N).astype(np.int32)
    vals = rng.uniform(0, 1, N).astype(np.float32)
    want = np.asarray(jax_ex(jm)(jnp.asarray(keys), jnp.asarray(vals), K // 8))
    got = port_spmd.build_all_to_all_exchange_aggregate(tm)(keys, vals, K // 8).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5)
    ref = np.zeros(K)
    np.add.at(ref, keys, vals)
    # shard d owns keys with key % 8 == d, local group id = key // 8
    np.testing.assert_allclose(got.reshape(8, K // 8).T.reshape(-1), ref, rtol=1e-4)


def test_psum_aggregate_with_integer_values(meshes):
    """A psum demo over a mask and two value functions: the count row is
    exact and equals the JAX package's; sums of small integers are exact
    in f32."""
    from ballista_tpu.parallel.spmd import build_psum_aggregate as jax_psum

    jm, tm = meshes
    rng = np.random.default_rng(2)
    N, G = 2048, 5
    codes = rng.integers(0, G, N).astype(np.int32)
    a = rng.integers(-20, 20, N).astype(np.float32)
    b = rng.integers(0, 9, N).astype(np.float32)

    def mask(a, b):
        return a > -5

    vfs = [lambda a, b: a, lambda a, b: a * b]
    want = np.asarray(jax_psum(jm, G, mask, vfs)(*(jnp.asarray(x) for x in (codes, a, b))))
    got = port_spmd.build_psum_aggregate(tm, G, mask, vfs)(codes, a, b).numpy()
    np.testing.assert_array_equal(got, want)


def test_mesh_shapes_and_devices():
    m = port_mesh.build_mesh(None, [torch.device("cpu")] * 4)
    assert m.shape == {"data": 4} and m.size == 4 and m.ranks == (0, 0, 0, 0)
    m = port_mesh.build_mesh({"data": 2, "model": 2}, CPU8)
    assert m.devices.shape == (2, 2) and m.axis_names == ("data", "model")
    with pytest.raises(ValueError, match="needs 16 devices"):
        port_mesh.build_mesh({"data": 16}, CPU8)
    assert port_mesh.default_devices("cpu") == [torch.device("cpu")]


def test_mesh_without_cuda_raises(monkeypatch):
    """No device list and no CUDA: the mesh never lands on the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_mesh.build_mesh()


def test_collectives_fold_in_shard_order():
    parts = [torch.tensor([1.5, -0.0, 3.0]), torch.tensor([-2.0, 0.0, float("inf")]),
             torch.tensor([7.0, -1.0, -float("inf")])]
    np.testing.assert_array_equal(port_spmd.psum(parts).numpy(),
                                  ((parts[0] + parts[1]) + parts[2]).numpy())
    np.testing.assert_array_equal(port_spmd.pmin(parts).numpy(), [-2.0, -1.0, -np.inf])
    np.testing.assert_array_equal(port_spmd.pmax(parts).numpy(), [7.0, 0.0, np.inf])
    ints = [torch.tensor([3, -4], dtype=torch.int32), torch.tensor([-9, 8], dtype=torch.int32)]
    assert port_spmd.pmin(ints).tolist() == [-9, -4]
    blocks = [torch.arange(4) + 10 * i for i in range(2)]
    got = port_spmd.all_to_all(blocks, [torch.device("cpu")] * 2)
    assert [g.tolist() for g in got] == [[0, 1, 10, 11], [2, 3, 12, 13]]
