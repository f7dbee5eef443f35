"""ballista_tpu_torch.ops.cuda_kernels.sorted_grouped_sum and
grouped_aggregate against the JAX package's Pallas kernels (interpret mode on
the CPU) on the same inputs.

On the CPU the wrappers run their plain PyTorch versions; the CUDA kernels
themselves are held against those plain versions on the card (the `cuda`
tests below, and chip_smoke.py). Tolerances: sorted_grouped_sum sums f32 rows
in another order than the reference, so sums agree within rtol 1e-5 and
atol 1e-5 x max|row sum|, and the mask row (counts) must be equal exactly;
grouped_aggregate within rtol 1e-4 / atol 1e-3, as in tests/test_pallas.py.
"""

import numpy as np
import pytest
import torch

from ballista_tpu.ops.pallas_kernels import SORT_BLOCK
from ballista_tpu.ops.pallas_kernels import grouped_aggregate as jax_grouped_aggregate
from ballista_tpu.ops.pallas_kernels import sorted_grouped_sum as jax_sorted_grouped_sum
from ballista_tpu_torch.ops import cuda_kernels
from ballista_tpu_torch.ops.cuda_kernels import (
    grouped_aggregate,
    grouped_aggregate_arrays,
    sorted_grouped_sum,
)


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


# -- grouped_aggregate ---------------------------------------------------------
def _ga_case(n, g, a, mask_p, seed, low=0, high=None):
    rng = np.random.default_rng(seed)
    codes = rng.integers(low, g if high is None else high, n).astype(np.int32)
    vals = rng.uniform(-5, 5, (n, a)).astype(np.float32)
    mask = rng.random(n) < mask_p
    return codes, vals, mask


def _ga_oracle(codes, vals, mask, g):
    ref = np.zeros((g, vals.shape[1]), dtype=np.float64)
    keep = mask & (codes >= 0) & (codes < g)
    np.add.at(ref, codes[keep], vals[keep].astype(np.float64))
    return ref


@pytest.mark.parametrize(
    "case",
    ["matches_reference", "unaligned_length", "declines_large_group_count",
     "empty_input_returns_zeros"],
)
def test_grouped_aggregate_matches_pallas(case):
    """The four cases of tests/test_pallas.py, through the port's numpy
    entry (plain version on the CPU) and the JAX kernel in interpret mode."""
    if case == "matches_reference":
        codes, vals, mask, g = (*_ga_case(4096, 6, 4, 0.6, seed=1), 6)
    elif case == "unaligned_length":  # not a multiple of the block size
        codes, vals, mask, g = (*_ga_case(3001, 5, 2, 1.0, seed=2), 5)
    elif case == "declines_large_group_count":
        codes, vals, mask, g = (np.zeros(10, np.int32), np.zeros((10, 1), np.float32),
                                np.ones(10, bool), 1000)
    else:
        codes, vals, mask, g = (np.zeros(0, np.int32), np.zeros((0, 3), np.float32),
                                np.zeros(0, bool), 4)
    want = jax_grouped_aggregate(codes, vals, mask, g, interpret=True)
    before = cuda_kernels.launch_counts()["grouped_aggregate"]
    got = grouped_aggregate_arrays(codes, vals, mask, g, device="cpu")
    assert cuda_kernels.launch_counts()["grouped_aggregate"] == before
    if want is None:
        assert got is None
        return
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got, _ga_oracle(codes, vals, mask, g), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("g,a", [(4, 8), (128, 3)])
def test_grouped_aggregate_out_of_range_codes(g, a):
    """Codes below 0 or at/above G add nothing, in the reference (no one-hot
    column matches them) and in the port."""
    codes, vals, mask = _ga_case(5000, g, a, 0.98, seed=3, low=-3, high=g + 3)
    want = jax_grouped_aggregate(codes, vals, mask, g, interpret=True)
    got = grouped_aggregate_arrays(codes, vals, mask, g, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got, _ga_oracle(codes, vals, mask, g), rtol=1e-4, atol=1e-3)


def test_grouped_aggregate_masked_rows_add_nothing():
    """The port's contract for non-finite inputs: a masked-out NaN or inf
    reaches no group (the reference multiplies by 0 and would spread it)."""
    codes, vals, mask = _ga_case(3000, 7, 3, 0.5, seed=4)
    vals[~mask] = np.nan
    vals[np.flatnonzero(~mask)[::2]] = np.inf
    got = grouped_aggregate(torch.from_numpy(codes), torch.from_numpy(vals),
                            torch.from_numpy(mask), 7).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _ga_oracle(codes, vals, mask, 7), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize(
    "codes,vals,mask,g,err",
    [
        (torch.zeros(4, dtype=torch.int64), torch.zeros(4, 2), torch.ones(4, dtype=torch.bool), 2, TypeError),
        (torch.zeros(4, dtype=torch.int32), torch.zeros(4, 2, dtype=torch.float64), torch.ones(4, dtype=torch.bool), 2, TypeError),
        (torch.zeros(4, dtype=torch.int32), torch.zeros(4, 2), torch.ones(4, dtype=torch.uint8), 2, TypeError),
        (torch.zeros(4, dtype=torch.int32), torch.zeros(5, 2), torch.ones(4, dtype=torch.bool), 2, ValueError),
        (torch.zeros(4, dtype=torch.int32), torch.zeros(4, 2), torch.ones(3, dtype=torch.bool), 2, ValueError),
        (torch.zeros(4, dtype=torch.int32), torch.zeros(4), torch.ones(4, dtype=torch.bool), 2, ValueError),
        (torch.zeros(4, dtype=torch.int32), torch.zeros(4, 2), torch.ones(4, dtype=torch.bool), 129, ValueError),
        (torch.zeros(4, dtype=torch.int32), torch.zeros(4, 2), torch.ones(4, dtype=torch.bool), -1, ValueError),
    ],
)
def test_grouped_aggregate_rejects_bad_inputs(codes, vals, mask, g, err):
    with pytest.raises(err):
        grouped_aggregate(codes, vals, mask, g)


@pytest.mark.cuda
def test_grouped_aggregate_kernel_matches_plain_on_gpu(cuda_device):
    """The CUDA kernel against its plain version on the card: few groups
    (contention), the 128-group cap, a ragged n and out-of-range codes."""
    for n, g, a in [(100_003, 4, 8), (65_537, 128, 5), (777, 3, 1)]:
        codes, vals, mask = _ga_case(n, g, a, 0.98, seed=n, low=-1, high=g + 1)
        c = torch.from_numpy(codes).to(cuda_device)
        v = torch.from_numpy(vals).to(cuda_device)
        m = torch.from_numpy(mask).to(cuda_device)
        before = cuda_kernels.launch_counts()["grouped_aggregate"]
        got = grouped_aggregate(c, v, m, g)
        torch.cuda.synchronize()
        assert cuda_kernels.launch_counts()["grouped_aggregate"] == before + 1
        want = cuda_kernels.grouped_aggregate_plain(c, v, m, g)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-4, atol=1e-3)
