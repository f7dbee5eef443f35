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


# -- the kernels' edges, on the card --------------------------------------------
def _sorted_values(n, nv, lens, seed, offset=0):
    """codes from run lengths (a tail that pads to n repeats the last code),
    a mask row and nv - 1 masked value rows; with offset > 0 both arrays
    start `offset` elements into a larger allocation (not 16-byte aligned)."""
    rng = np.random.default_rng(seed)
    codes = np.repeat(np.arange(len(lens), dtype=np.int32), lens)[:n]
    codes = np.concatenate([codes, np.full(n - len(codes), codes[-1], np.int32)])
    mask = (rng.random(n) < 0.8).astype(np.float32)
    vals = rng.normal(size=(nv, n)).astype(np.float32) * mask
    vals[0] = mask
    c = torch.zeros(n + offset, dtype=torch.int32)
    c[offset:] = torch.from_numpy(codes)
    v = torch.zeros(nv * n + offset, dtype=torch.float32)
    v[offset:] = torch.from_numpy(vals.reshape(-1))
    return c[offset:], v[offset:].view(nv, n), int(codes.max()) + 1


def _check_sorted_on_gpu(codes, vals, G, dev):
    c, v = codes.to(dev), vals.to(dev)
    if codes.storage_offset():  # keep the offset on the card
        c = torch.zeros(codes.numel() + codes.storage_offset(), dtype=torch.int32,
                        device=dev)[codes.storage_offset():]
        c.copy_(codes)
        v = torch.zeros(vals.numel() + vals.storage_offset(), device=dev)[
            vals.storage_offset():].view(vals.shape)
        v.copy_(vals)
    before = cuda_kernels.launch_counts()["sorted_grouped_sum"]
    got = sorted_grouped_sum(c, v, G)
    again = sorted_grouped_sum(c, v, G)
    torch.cuda.synchronize()
    assert cuda_kernels.launch_counts()["sorted_grouped_sum"] == before + 2
    want = cuda_kernels.sorted_grouped_sum_plain(c, v, G)
    _assert_matches(got.cpu().numpy(), want.cpu().numpy())
    # a fixed summation order: two runs agree bit for bit
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096 * 3 + 1, 4096 * 3 + 2, 4096 * 3 + 3, 2048, 2049, 31])
@pytest.mark.parametrize("nv", [1, 2, 5, 9])
def test_sorted_kernel_unaligned_rows_on_gpu(cuda_device, n, nv):
    """Value rows that start 4, 8 or 12 bytes past a 16-byte boundary (n mod
    4 != 0), n below, at and one past a tile, and nv above the 4 value rows
    of one pass over the codes."""
    rng = np.random.default_rng(n + nv)
    codes, vals, G = _sorted_values(n, nv, rng.integers(1, 9, n), seed=n)
    _check_sorted_on_gpu(codes, vals, G, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5, 2047, 2048 * 7 + 3, 1_000_003])
def test_sorted_kernel_single_group_on_gpu(cuda_device, n):
    """One group spanning the whole input (many tiles: the fix-up pass)."""
    codes, vals, G = _sorted_values(n, 3, [n], seed=n)
    _check_sorted_on_gpu(codes, vals, G, cuda_device)


@pytest.mark.cuda
def test_sorted_kernel_edges_on_gpu(cuda_device):
    """Arrays that start off a 16-byte boundary, groups that no row holds
    (written 0 by the kernel, which does not zero its output), and runs of
    every length across tile edges."""
    rng = np.random.default_rng(7)
    lens = np.concatenate([[1], rng.integers(1, 3000, 60), [4096], [5000]])
    n = int(lens.sum())
    for offset in (1, 2, 3):
        codes, vals, G = _sorted_values(n, 3, lens, seed=offset, offset=offset)
        _check_sorted_on_gpu(codes, vals, G, cuda_device)
    codes, vals, G = _sorted_values(5000, 2, rng.integers(1, 5, 5000), seed=8)
    sparse = codes * 3 + 2  # groups 0, 1, 3, 4, ... hold no row
    c, v = sparse.to(cuda_device), vals.to(cuda_device)
    got = sorted_grouped_sum(c, v, int(sparse.max()) + 5)
    want = cuda_kernels.sorted_grouped_sum_plain(c, v, int(sparse.max()) + 5)
    _assert_matches(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("a", [1, 3, 7, 8, 9])
@pytest.mark.parametrize("g", [1, 4, 6, 128])
def test_grouped_aggregate_kernel_shapes_on_gpu(cuda_device, a, g):
    """Every mode of the kernel: A not a multiple of 4 (q1's 7), G up to
    the cap, a ragged n, out-of-range codes and NaN in masked-out rows."""
    n = 100_003
    codes, vals, mask = _ga_case(n, g, a, 0.9, seed=a * 1000 + g, low=-1, high=g + 1)
    vals[~mask] = np.nan
    c, v, m = (torch.from_numpy(x).to(cuda_device) for x in (codes, vals, mask))
    got = grouped_aggregate(c, v, m, g)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), _ga_oracle(codes, vals, mask, g),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_grouped_aggregate_kernel_edges_on_gpu(cuda_device):
    """All masks false; inputs that start off a 16-byte boundary; the
    "warp tiles" mode with more columns than the unrolled 8, and with
    tiles too large for one per warp (warps share them and add with
    atomics; past 48 KB one tile per block)."""
    codes, vals, mask = _ga_case(50_001, 6, 7, 0.0, seed=1)
    got = grouped_aggregate(*(torch.from_numpy(x).to(cuda_device)
                              for x in (codes, vals, mask)), 6)
    assert not got.any()
    for off in (1, 3):
        codes, vals, mask = _ga_case(70_001, 4, 7, 0.7, seed=off)
        c = torch.zeros(len(codes) + off, dtype=torch.int32, device=cuda_device)[off:]
        v = torch.zeros(vals.size + off, device=cuda_device)[off:].view(vals.shape)
        m = torch.zeros(len(mask) + off, dtype=torch.bool, device=cuda_device)[off:]
        c.copy_(torch.from_numpy(codes))
        v.copy_(torch.from_numpy(vals))
        m.copy_(torch.from_numpy(mask))
        np.testing.assert_allclose(grouped_aggregate(c, v, m, 4).cpu().numpy(),
                                   _ga_oracle(codes, vals, mask, 4), rtol=1e-4, atol=1e-3)
    assert cuda_kernels.grouped_aggregate_geometry(10, 3, 300)[0] == cuda_kernels.GA_MODE_WARP_TILES
    codes, vals, mask = _ga_case(3_001, 3, 300, 0.9, seed=5)
    got = grouped_aggregate(*(torch.from_numpy(x).to(cuda_device)
                              for x in (codes, vals, mask)), 3)
    np.testing.assert_allclose(got.cpu().numpy(), _ga_oracle(codes, vals, mask, 3),
                               rtol=1e-4, atol=1e-3)
    for n, g, a in [(40_001, 128, 20), (5_003, 128, 300)]:
        codes, vals, mask = _ga_case(n, g, a, 0.9, seed=a)
        got = grouped_aggregate(*(torch.from_numpy(x).to(cuda_device)
                                  for x in (codes, vals, mask)), g)
        np.testing.assert_allclose(got.cpu().numpy(), _ga_oracle(codes, vals, mask, g),
                                   rtol=1e-4, atol=1e-3)
