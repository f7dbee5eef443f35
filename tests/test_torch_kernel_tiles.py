"""The work split of the port's CUDA kernels, modelled in numpy, against the
JAX package's Pallas kernels (interpret mode on the CPU) on the same inputs.

The CUDA kernels run only on the card; these models repeat their
decomposition step by step, so that a fault in the split (a run that crosses
a tile, a group that no row holds, a ragged tile, a column that a thread
owns) shows here on the CPU:

- sorted_grouped_sum (csrc/sorted_grouped_sum.cu): tiles of T rows, strips
  of 8 rows per thread, each strip's last-run sum carried to the next strip
  by a segmented scan; pass 1 writes each run that ends in its tile and did
  not start before it, and each tile's first and last run sums to scratch;
  pass 2 sums the pieces of every run that crossed a tile edge in tile
  order. Every output element must be written exactly once.
- grouped_aggregate (csrc/grouped_aggregate.cu): "registers" (G <= 8,
  A <= 8): tiles of R rows dealt to persistent blocks, one row per thread,
  per-thread [8, A] sums by group reduced per warp and per block;
  "warp tiles" (otherwise): rows walked by a grid of threads into per-warp
  [G, A] tiles summed per block; the block partials are added into the
  output.

Tolerances are the kernels' tests': sums within rtol 1e-5 and atol 1e-5 x
max|row sum| for sorted_grouped_sum, with counts (row 0) exactly equal;
rtol 1e-4 / atol 1e-3 for grouped_aggregate.
"""

import functools

import numpy as np
import pytest

from ballista_tpu.ops.pallas_kernels import SORT_BLOCK
from ballista_tpu.ops.pallas_kernels import grouped_aggregate as jax_grouped_aggregate
from ballista_tpu.ops.pallas_kernels import sorted_grouped_sum as jax_sorted_grouped_sum
from ballista_tpu_torch.ops import cuda_kernels as ck

STRIP = 8  # rows per thread in sorted_grouped_sum
THREADS = 256
# the reference runs at one padded shape per nv (one interpret-mode compile)
SGS_ROWS_PAD, SGS_GROUPS_PAD = 7 * SORT_BLOCK, 4096
GA_ROWS = 2500


# -- sorted_grouped_sum --------------------------------------------------------
def sgs_model(codes, vals, num_groups, tile_rows):
    """The kernel's two passes over tiles of `tile_rows` rows. Returns the
    output and how many times each element was written."""
    f32 = np.float32
    n, nv = len(codes), vals.shape[0]
    tiles = -(-n // tile_rows)
    scratch = np.full((tiles, 2, nv), np.nan, f32)
    out = np.zeros((nv, num_groups), f32)
    writes = np.zeros((nv, num_groups), np.int64)

    def put(g, val):
        out[:, g] = val
        writes[:, g] += 1

    for g in range(min(int(codes[0]), num_groups)):  # below the first code
        put(g, 0.0)
    for t in range(tiles):
        r0, r1 = t * tile_rows, min((t + 1) * tile_rows, n)
        k, x = codes[r0:r1], vals[:, r0:r1]
        first, last = k[0], k[-1]
        crossed_in = r0 > 0 and codes[r0 - 1] == first
        # the segmented scan: the sum of the run open at each strip's end
        carry_out = np.zeros(nv, f32)
        for s0 in range(0, r1 - r0, STRIP):
            strip = range(s0, min(s0 + STRIP, r1 - r0))
            cont = s0 > 0 and k[s0] == k[s0 - 1]
            acc = carry_out.copy() if cont else np.zeros(nv, f32)
            tail, uniform = np.zeros(nv, f32), True
            for j in strip:
                if j > s0 and k[j] != k[j - 1]:
                    uniform, tail = False, np.zeros(nv, f32)
                tail = (tail + x[:, j]).astype(f32)
            start = not (uniform and cont)
            carry_out = tail if start else (carry_out + tail).astype(f32)
            for j in strip:
                acc = (acc + x[:, j]).astype(f32)
                tile_end = j == r1 - r0 - 1
                if not tile_end and k[j + 1] == k[j]:
                    continue
                key = int(k[j])
                if key == first:
                    scratch[t, 0] = acc
                elif key == last:
                    scratch[t, 1] = acc
                if not tile_end or r1 == n or codes[r1] != key:
                    if not (key == first and crossed_in) and 0 <= key < num_groups:
                        put(key, acc)
                    nk = int(k[j + 1]) if not tile_end else (
                        int(codes[r1]) if r1 < n else num_groups)
                    for g in range(max(key + 1, 0), min(nk, num_groups)):
                        put(g, 0.0)
                acc = np.zeros(nv, f32)
    # pass 2: runs that crossed into tile t and end there
    lasts = np.array([codes[min((s + 1) * tile_rows, n) - 1] for s in range(tiles)])
    for t in range(1, tiles):
        r0, r1 = t * tile_rows, min((t + 1) * tile_rows, n)
        key = int(codes[r0])
        if codes[r0 - 1] != key or (r1 < n and codes[r1] == key):
            continue
        if not 0 <= key < num_groups:
            continue
        s0 = int(np.searchsorted(lasts[:t], key, side="left"))
        head = codes[s0 * tile_rows] == key
        total = np.zeros(nv, f32)
        for s in range(s0, t + 1):
            total = (total + scratch[s, 0 if (s > s0 or head) else 1]).astype(f32)
        put(key, total)
    return out, writes


def _sgs_case(kind, tile_rows, nv, seed):
    rng = np.random.default_rng(seed)
    T = tile_rows
    if kind == "below_one_tile":
        n, lens = T - 1, rng.integers(1, 6, T)
    elif kind == "one_tile":
        n, lens = T, rng.integers(1, 6, T)
    elif kind == "one_tile_plus_one":
        n, lens = T + 1, rng.integers(1, 6, T + 1)
    elif kind == "runs_cross_no_tile":  # every run ends on or before a tile edge
        n, lens = 4 * T, np.tile([T // 4, T // 8, T // 8, T // 2], 4)
    elif kind == "runs_cross_one_tile":
        n, lens = 4 * T + 7, np.concatenate([[T // 2], np.full(4, T)])
    elif kind == "run_crosses_many_tiles":
        n, lens = 6 * T + 5, np.concatenate([[3], rng.integers(1, 4, 10), [4 * T + 3],
                                             rng.integers(1, 9, 2 * T)])
    elif kind == "groups_without_rows":
        n, lens = 3 * T + 2, rng.integers(1, 40, 3 * T)
    else:
        raise ValueError(kind)
    codes = np.repeat(np.arange(len(lens), dtype=np.int32), lens)[:n]
    if kind == "groups_without_rows":
        codes = codes * 3 + 2
    mask = (rng.random(n) < 0.7).astype(np.float32)
    vals = rng.normal(size=(nv, n)).astype(np.float32) * mask
    vals[0] = mask
    return codes, vals, int(codes.max()) + 1 + (3 if kind == "groups_without_rows" else 0)


def _sgs_reference(codes, vals, num_groups):
    """The JAX kernel at one padded shape: padded rows repeat the last code
    with zero values (as the JAX stage pads), groups padded to 4096."""
    import jax.numpy as jnp

    n, nv = len(codes), vals.shape[0]
    assert n <= SGS_ROWS_PAD and num_groups <= SGS_GROUPS_PAD
    codes_p = np.concatenate([codes, np.full(SGS_ROWS_PAD - n, codes[-1], np.int32)])
    vals_p = np.concatenate([vals, np.zeros((nv, SGS_ROWS_PAD - n), np.float32)], axis=1)
    out = jax_sorted_grouped_sum(jnp.asarray(codes_p), jnp.asarray(vals_p),
                                 SGS_GROUPS_PAD, interpret=True)
    return np.asarray(out)[:, :num_groups]


def _assert_sgs(got, writes, want):
    assert (writes == 1).all(), "every output element is written exactly once"
    np.testing.assert_array_equal(got[0], want[0])  # counts: exact
    scale = np.abs(want).max(axis=1, keepdims=True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=float(1e-5 * scale.max()))


SGS_KINDS = ["below_one_tile", "one_tile", "one_tile_plus_one", "runs_cross_no_tile",
             "runs_cross_one_tile", "run_crosses_many_tiles", "groups_without_rows"]


@pytest.mark.parametrize("tile_rows", [32, 64, 1024])
@pytest.mark.parametrize("kind", SGS_KINDS)
def test_sorted_tiles_model_matches_pallas(kind, tile_rows):
    nv = 1 + (SGS_KINDS.index(kind) + tile_rows) % 5
    codes, vals, G = _sgs_case(kind, tile_rows, nv, seed=tile_rows)
    got, writes = sgs_model(codes, vals, G, tile_rows)
    _assert_sgs(got, writes, _sgs_reference(codes, vals, G))


@pytest.mark.parametrize("nv", [1, 2, 3, 4, 5])
def test_sorted_tiles_model_value_rows(nv):
    """nv of 1 to 5 over a run that spans many tiles (nv = 5 takes a second
    pass over the codes in the kernel)."""
    codes, vals, G = _sgs_case("run_crosses_many_tiles", 64, nv, seed=nv)
    got, writes = sgs_model(codes, vals, G, 64)
    _assert_sgs(got, writes, _sgs_reference(codes, vals, G))


def test_sorted_tiles_model_out_of_range_codes():
    """Codes outside [0, G) add nothing and leave no element unwritten."""
    codes, vals, _ = _sgs_case("runs_cross_one_tile", 32, 2, seed=3)
    codes = codes - 1  # the first run becomes code -1
    G = int(codes.max())  # the last run's code is G: out of range
    got, writes = sgs_model(codes, vals, G, 32)
    oracle = np.zeros((2, G), np.float64)
    keep = (codes >= 0) & (codes < G)
    for v in range(2):
        np.add.at(oracle[v], codes[keep], vals[v, keep].astype(np.float64))
    assert (writes == 1).all()
    np.testing.assert_array_equal(got[0], oracle[0])
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n,nv", [(1, 1), (2048, 2), (2049, 3), (5_999_554, 2), (7_560_496, 9)])
def test_sorted_geometry(n, nv):
    tiles, shape, passes = ck.sorted_grouped_sum_geometry(n, nv)
    assert tiles == -(-n // ck.SORTED_TILE_ROWS)
    assert (tiles - 1) * ck.SORTED_TILE_ROWS < n <= tiles * ck.SORTED_TILE_ROWS
    assert shape == (tiles, 2, nv)
    assert passes == -(-nv // ck.SORTED_VALUE_ROWS_PER_PASS)
    assert ck.SORTED_TILE_ROWS % (4 * STRIP) == 0  # strips start on 16 bytes


# -- grouped_aggregate ---------------------------------------------------------
def ga_model(codes, vals, mask, num_groups, tile_rows, blocks=3):
    """The kernel's split. "registers": tiles of `tile_rows` rows dealt to
    `blocks` persistent blocks, row i of a tile to thread i % 256, which sums
    each of its rows into [8, A] registers by group; the block reduces its
    threads' sums (by warp, then across warps) and adds the partials into
    the output. "warp tiles": a grid of `blocks` x 256 threads walks the
    rows, each warp adding its rows into its own [G, A] tile; the block sums
    its 8 tiles and adds the result into the output."""
    n, A = vals.shape
    mode, _, _ = ck.grouped_aggregate_geometry(n, num_groups, A)
    keep = mask & (codes >= 0) & (codes < num_groups)
    out = np.zeros((num_groups, A), np.float32)
    if mode == ck.GA_MODE_REGISTERS:
        tiles = -(-n // tile_rows)
        for b in range(blocks):
            acc = np.zeros((THREADS, 8, A), np.float32)
            for t in range(b, tiles, blocks):
                rows = np.arange(t * tile_rows, min((t + 1) * tile_rows, n))
                rows = rows[keep[rows]]
                np.add.at(acc, ((rows - t * tile_rows) % THREADS, codes[rows]), vals[rows])
            warps = acc.reshape(THREADS // 32, 32, 8, A).sum(axis=1, dtype=np.float32)
            out += warps.sum(axis=0, dtype=np.float32)[:num_groups]
    else:
        assert mode == ck.GA_MODE_WARP_TILES
        rows = np.flatnonzero(keep)
        thread = rows % (blocks * THREADS)
        tiles = np.zeros((blocks, THREADS // 32, num_groups, A), np.float32)
        np.add.at(tiles, (thread // THREADS, thread % THREADS // 32, codes[rows]), vals[rows])
        out += tiles.sum(axis=1, dtype=np.float32).sum(axis=0, dtype=np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _ga_data(g, a):
    rng = np.random.default_rng(g * 100 + a)
    codes = rng.integers(-1, g + 1, GA_ROWS).astype(np.int32)
    vals = rng.uniform(-5, 5, (GA_ROWS, a)).astype(np.float32)
    mask = rng.random(GA_ROWS) < 0.8
    want = np.asarray(jax_grouped_aggregate(codes, vals, mask, g, interpret=True))
    return codes, vals, mask, want


@pytest.mark.parametrize("tile_rows", [32, 64, 1024])
@pytest.mark.parametrize("g", [1, 4, 6, 128])
@pytest.mark.parametrize("a", [1, 3, 7, 8, 9])
def test_grouped_aggregate_tiles_model_matches_pallas(a, g, tile_rows):
    codes, vals, mask, want = _ga_data(g, a)
    got = ga_model(codes, vals, mask, g, tile_rows)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_grouped_aggregate_tiles_model_masked_rows_add_nothing():
    """Masked-out rows with NaN reach no group in the model's split either."""
    codes, vals, mask, _ = _ga_data(6, 7)
    vals = vals.copy()
    vals[~mask] = np.nan
    got = ga_model(codes, vals, mask, 6, 64)
    assert np.isfinite(got).all()
    keep = mask & (codes >= 0) & (codes < 6)
    ref = np.zeros((6, 7))
    np.add.at(ref, codes[keep], vals[keep].astype(np.float64))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize(
    "g,a,mode",
    [(1, 1, ck.GA_MODE_REGISTERS), (6, 7, ck.GA_MODE_REGISTERS),
     (8, 8, ck.GA_MODE_REGISTERS), (4, 9, ck.GA_MODE_WARP_TILES),
     (8, 256, ck.GA_MODE_WARP_TILES), (9, 8, ck.GA_MODE_WARP_TILES),
     (128, 8, ck.GA_MODE_WARP_TILES), (128, 17, ck.GA_MODE_WARP_TILES),
     (128, 257, ck.GA_MODE_WARP_TILES), (1, 300, ck.GA_MODE_WARP_TILES)],
)
def test_grouped_aggregate_geometry(g, a, mode):
    got_mode, rows, tiles = ck.grouped_aggregate_geometry(5_999_554, g, a)
    assert got_mode == mode
    assert 1 <= rows <= 1024 and (rows % 16 == 0 or rows < 16)
    assert rows * a * 4 <= 32 * 1024 or rows == 1
    assert tiles == -(-5_999_554 // rows)
