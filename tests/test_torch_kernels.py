"""ballista_tpu_torch.ops.cuda_kernels.sorted_grouped_sum against the JAX
package's Pallas kernel (interpret mode on the CPU) on the same inputs.

On the CPU the wrapper runs its plain PyTorch version; the CUDA kernel itself
is held against that plain version on the card (the `cuda` test below, and
chip_smoke.py). Tolerance: both sum f32 rows in different orders, so sums
agree within rtol 1e-5 and atol 1e-5 x max|row sum|; the mask row (counts)
must be equal exactly.
"""

import numpy as np
import pytest
import torch

from ballista_tpu.ops.pallas_kernels import SORT_BLOCK
from ballista_tpu.ops.pallas_kernels import sorted_grouped_sum as jax_sorted_grouped_sum
from ballista_tpu_torch.ops import cuda_kernels
from ballista_tpu_torch.ops.cuda_kernels import sorted_grouped_sum


@pytest.fixture
def cuda_device():
    """A CUDA torch.device for tests marked `cuda`; skips where PyTorch
    sees no GPU (decided here, at run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _case(kind: str, nv: int, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "single_row_groups":
        lens = np.ones(700, dtype=np.int64)
    elif kind == "one_group_many_blocks":
        lens = np.concatenate([[5], [3 * SORT_BLOCK + 17], rng.integers(1, 6, 40)])
    elif kind == "many_groups":  # G > 1024
        lens = rng.integers(1, 4, 1500)
    elif kind == "ragged":  # N not a multiple of SORT_BLOCK
        lens = rng.integers(1, 30, 97)
    else:
        raise ValueError(kind)
    codes = np.repeat(np.arange(len(lens), dtype=np.int32), lens)
    n = len(codes)
    mask = (rng.random(n) < 0.7).astype(np.float32)
    vals = rng.normal(size=(nv, n)).astype(np.float32)
    vals[0] = mask
    vals[1:] *= mask
    return codes, vals, len(lens)


def _jax_reference(codes, vals, G):
    import jax.numpy as jnp

    n = len(codes)
    pad = (-n) % SORT_BLOCK
    # the JAX kernel needs N % 1024 == 0: padded rows repeat the last code
    # with zero values, as the JAX stage pads them
    codes_p = np.concatenate([codes, np.full(pad, codes[-1], np.int32)])
    vals_p = np.concatenate([vals, np.zeros((vals.shape[0], pad), np.float32)], axis=1)
    out = jax_sorted_grouped_sum(
        jnp.asarray(codes_p), jnp.asarray(vals_p), G, interpret=True
    )
    return np.asarray(out)


def _assert_matches(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[0], want[0])  # counts: exact
    scale = np.abs(want).max(axis=1, keepdims=True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=float(1e-5 * scale.max()))


@pytest.mark.parametrize(
    "kind,nv",
    [
        ("single_row_groups", 1),
        ("single_row_groups", 3),
        ("one_group_many_blocks", 2),
        ("one_group_many_blocks", 4),
        ("many_groups", 2),
        ("many_groups", 3),
        ("ragged", 1),
        ("ragged", 4),
    ],
)
def test_sorted_grouped_sum_matches_pallas(kind, nv):
    codes, vals, G = _case(kind, nv, seed=11)
    want = _jax_reference(codes, vals, G)
    before = cuda_kernels.launch_counts()["sorted_grouped_sum"]
    got = sorted_grouped_sum(torch.from_numpy(codes), torch.from_numpy(vals), G)
    _assert_matches(got.numpy(), want)
    # the plain version on CPU tensors is not a kernel launch
    assert cuda_kernels.launch_counts()["sorted_grouped_sum"] == before


def test_plain_version_matches_numpy_oracle():
    codes, vals, G = _case("many_groups", 3, seed=5)
    oracle = np.zeros((3, G), np.float64)
    for v in range(3):
        np.add.at(oracle[v], codes, vals[v].astype(np.float64))
    got = cuda_kernels.sorted_grouped_sum_plain(
        torch.from_numpy(codes), torch.from_numpy(vals), G
    ).numpy()
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "codes,vals,err",
    [
        (torch.zeros(4, dtype=torch.int64), torch.zeros(1, 4), TypeError),
        (torch.zeros(4, dtype=torch.int32), torch.zeros(1, 4, dtype=torch.float64), TypeError),
        (torch.zeros(4, dtype=torch.int32), torch.zeros(1, 5), ValueError),
        (torch.zeros(4, dtype=torch.int32), torch.zeros(4), ValueError),
    ],
)
def test_wrapper_rejects_bad_inputs(codes, vals, err):
    with pytest.raises(err):
        sorted_grouped_sum(codes, vals, 2)


@pytest.mark.cuda
def test_kernel_matches_plain_on_gpu(cuda_device):
    """The CUDA kernel against its plain version on the card."""
    codes, vals, G = _case("one_group_many_blocks", 3, seed=2)
    c = torch.from_numpy(codes).to(cuda_device)
    v = torch.from_numpy(vals).to(cuda_device)
    before = cuda_kernels.launch_counts()["sorted_grouped_sum"]
    got = sorted_grouped_sum(c, v, G)
    torch.cuda.synchronize()
    assert cuda_kernels.launch_counts()["sorted_grouped_sum"] == before + 1
    want = cuda_kernels.sorted_grouped_sum_plain(c, v, G)
    _assert_matches(got.cpu().numpy(), want.cpu().numpy())
