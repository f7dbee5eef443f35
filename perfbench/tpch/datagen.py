"""Deterministic vectorized TPC-H data generator (dbgen-lite).

Frozen copy of benchmarks/tpch/datagen.py at commit aab2caf. The tables and
their bytes are unchanged; `generate` can write the chunks of each table in
worker processes (`workers`), which leaves every file byte-identical because
each chunk draws from its own generator rng([seed, table tag, chunk]).

The reference relies on dockerized dbgen (rust/benchmarks/tpch/tpch-gen.sh,
tpchgen.dockerfile); no network/docker here, so this generates the same table
shapes with dbgen's row counts, key relationships, value domains, and the
string distributions the 22 queries filter on (brands, types, containers,
segments, priorities, ship modes, nations/regions, phone prefixes,
comment keywords). Not bit-identical to dbgen — q outputs differ numerically
from published TPC-H answers, so correctness tests compare against an
independent oracle (pyarrow/pandas) on the same data.

Usage: python -m perfbench.tpch.datagen --sf 0.01 --out <dir> --parts 2
"""

from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from perfbench.tpch.schema import TPCH_TABLES, get_tpch_schema

NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
INSTRUCTIONS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
CONTAINERS = [
    f"{a} {b}"
    for a in ["SM", "LG", "MED", "JUMBO", "WRAP"]
    for b in ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
]
TYPE_1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
COLORS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished", "chartreuse",
    "chiffon", "chocolate", "coral", "cornflower", "cornsilk", "cream", "cyan",
    "dark", "deep", "dim", "dodger", "drab", "firebrick", "floral", "forest",
    "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey", "honeydew",
    "hot", "hyacinth", "indian", "ivory", "khaki", "lace", "lavender", "lawn",
]
COMMENT_WORDS = [
    "carefully", "quickly", "furiously", "slyly", "blithely", "special",
    "requests", "packages", "deposits", "accounts", "instructions", "pending",
    "unusual", "express", "regular", "ironic", "final", "bold", "silent",
    "even", "daring", "brave", "quiet", "complaints", "theodolites",
]

DATE_EPOCH = np.datetime64("1970-01-01")
START = (np.datetime64("1992-01-01") - DATE_EPOCH).astype(np.int32)
END = (np.datetime64("1998-08-02") - DATE_EPOCH).astype(np.int32)


def _take(pool: List[str], idx: np.ndarray) -> pa.Array:
    """Build a string column by dictionary take (vectorized, no python loop)."""
    return pa.DictionaryArray.from_arrays(
        pa.array(idx, type=pa.int32()), pa.array(pool)
    ).cast(pa.string())


def _comments(rng: np.random.Generator, n: int) -> pa.Array:
    import pyarrow.compute as pc

    w = [
        _take(COMMENT_WORDS, rng.integers(0, len(COMMENT_WORDS), n))
        for _ in range(3)
    ]
    return pc.binary_join_element_wise(w[0], w[1], w[2], " ")


def _numbered(prefix: str, keys: np.ndarray) -> pa.Array:
    return pa.array(np.char.mod(prefix + "#%09d", keys))


def gen_region() -> pa.Table:
    return pa.table(
        {
            "r_regionkey": pa.array(np.arange(5, dtype=np.int64)),
            "r_name": pa.array(REGIONS),
            "r_comment": pa.array(["" for _ in REGIONS]),
        },
        schema=get_tpch_schema("region"),
    )


def gen_nation() -> pa.Table:
    return pa.table(
        {
            "n_nationkey": pa.array(np.arange(25, dtype=np.int64)),
            "n_name": pa.array([n for n, _ in NATIONS]),
            "n_regionkey": pa.array(np.array([r for _, r in NATIONS], dtype=np.int64)),
            "n_comment": pa.array(["" for _ in NATIONS]),
        },
        schema=get_tpch_schema("nation"),
    )


def gen_supplier(sf: float, rng: np.random.Generator) -> pa.Table:
    n = max(1, int(10_000 * sf))
    keys = np.arange(1, n + 1, dtype=np.int64)
    nk = rng.integers(0, 25, n).astype(np.int64)
    phone = pa.array(np.char.mod("%02d-989-741-2988", 10 + nk))
    return pa.table(
        {
            "s_suppkey": keys,
            "s_name": _numbered("Supplier", keys),
            "s_address": _numbered("Addr", keys),
            "s_nationkey": nk,
            "s_phone": phone,
            "s_acctbal": np.round(rng.uniform(-999.99, 9999.99, n), 2),
            "s_comment": _comments(rng, n),
        },
        schema=get_tpch_schema("supplier"),
    )


def gen_part(sf: float, rng: np.random.Generator, lo: int = 0,
             n: int = None) -> pa.Table:
    import pyarrow.compute as pc

    if n is None:
        n = max(1, int(200_000 * sf))
    keys = np.arange(lo + 1, lo + n + 1, dtype=np.int64)
    name = pc.binary_join_element_wise(
        _take(COLORS, rng.integers(0, len(COLORS), n)),
        _take(COLORS, rng.integers(0, len(COLORS), n)),
        " ",
    )
    # Brand#MN with M,N in 1..5
    m = rng.integers(1, 6, n)
    nn = rng.integers(1, 6, n)
    brand = pa.array(np.char.mod("Brand#%d", m * 10 + nn))
    ptype = pc.binary_join_element_wise(
        _take(TYPE_1, rng.integers(0, len(TYPE_1), n)),
        _take(TYPE_2, rng.integers(0, len(TYPE_2), n)),
        _take(TYPE_3, rng.integers(0, len(TYPE_3), n)),
        " ",
    )
    return pa.table(
        {
            "p_partkey": keys,
            "p_name": name,
            "p_mfgr": pa.array(np.char.mod("Manufacturer#%d", rng.integers(1, 6, n))),
            "p_brand": brand,
            "p_type": ptype,
            "p_size": rng.integers(1, 51, n).astype(np.int32),
            "p_container": _take(CONTAINERS, rng.integers(0, len(CONTAINERS), n)),
            "p_retailprice": np.round(
                900 + (keys % 1000) / 10 + 100 * (keys % 10), 2
            ).astype(np.float64),
            "p_comment": _comments(rng, n),
        },
        schema=get_tpch_schema("part"),
    )


def gen_partsupp(sf: float, rng: np.random.Generator, lo: int = 0,
                 n: int = None) -> pa.Table:
    # lo/n are in PART-key space (4 rows per part)
    n_part = max(1, int(200_000 * sf))
    n_supp = max(1, int(10_000 * sf))
    if n is None:
        lo, n = 0, n_part
    pk = np.repeat(np.arange(lo + 1, lo + n + 1, dtype=np.int64), 4)
    i = np.tile(np.arange(4, dtype=np.int64), n)
    sk = ((pk + i * (n_supp // 4 + 1)) % n_supp) + 1
    n = len(pk)
    return pa.table(
        {
            "ps_partkey": pk,
            "ps_suppkey": sk,
            "ps_availqty": rng.integers(1, 10_000, n).astype(np.int32),
            "ps_supplycost": np.round(rng.uniform(1.0, 1000.0, n), 2),
            "ps_comment": _comments(rng, n),
        },
        schema=get_tpch_schema("partsupp"),
    )


def gen_customer(sf: float, rng: np.random.Generator, lo: int = 0,
                 n: int = None) -> pa.Table:
    if n is None:
        n = max(1, int(150_000 * sf))
    keys = np.arange(lo + 1, lo + n + 1, dtype=np.int64)
    nk = rng.integers(0, 25, n).astype(np.int64)
    return pa.table(
        {
            "c_custkey": keys,
            "c_name": _numbered("Customer", keys),
            "c_address": _numbered("Addr", keys),
            "c_nationkey": nk,
            "c_phone": pa.array(np.char.mod("%02d-467-109-8538", 10 + nk)),
            "c_acctbal": np.round(rng.uniform(-999.99, 9999.99, n), 2),
            "c_mktsegment": _take(SEGMENTS, rng.integers(0, len(SEGMENTS), n)),
            "c_comment": _comments(rng, n),
        },
        schema=get_tpch_schema("customer"),
    )


def gen_orders(sf: float, rng: np.random.Generator, lo: int = 0,
               n: int = None) -> pa.Table:
    if n is None:
        n = max(1, int(1_500_000 * sf))
    n_cust = max(1, int(150_000 * sf))
    keys = np.arange(lo + 1, lo + n + 1, dtype=np.int64)
    # dbgen: only 2/3 of customers have orders
    ck = (rng.integers(0, max(1, n_cust * 2 // 3), n) * 3 % n_cust) + 1
    odate = rng.integers(START, END - 121, n).astype(np.int32)
    return pa.table(
        {
            "o_orderkey": keys,
            "o_custkey": ck.astype(np.int64),
            "o_orderstatus": _take(["O", "F", "P"], rng.integers(0, 3, n)),
            "o_totalprice": np.round(rng.uniform(850.0, 560_000.0, n), 2),
            "o_orderdate": pa.array(odate, type=pa.date32()),
            "o_orderpriority": _take(PRIORITIES, rng.integers(0, 5, n)),
            "o_clerk": _numbered("Clerk", rng.integers(1, max(2, int(1000 * sf) + 1), n).astype(np.int64)),
            "o_shippriority": np.zeros(n, dtype=np.int32),
            "o_comment": _comments(rng, n),
        },
        schema=get_tpch_schema("orders"),
    )


def gen_lineitem(sf: float, rng: np.random.Generator, orders: pa.Table) -> pa.Table:
    n_part = max(1, int(200_000 * sf))
    n_supp = max(1, int(10_000 * sf))
    okeys = orders.column("o_orderkey").to_numpy()
    odates = orders.column("o_orderdate").cast(pa.int32()).to_numpy()
    lines_per = rng.integers(1, 8, len(okeys))
    lok = np.repeat(okeys, lines_per)
    lod = np.repeat(odates, lines_per)
    n = len(lok)
    linenumber = (
        np.arange(n, dtype=np.int64)
        - np.repeat(np.concatenate(([0], np.cumsum(lines_per)[:-1])), lines_per)
        + 1
    )
    pk = rng.integers(1, n_part + 1, n).astype(np.int64)
    # dbgen supplier selection: one of 4 suppliers for the part
    i = rng.integers(0, 4, n)
    sk = ((pk + i * (n_supp // 4 + 1)) % n_supp) + 1
    qty = rng.integers(1, 51, n).astype(np.float64)
    extprice = np.round(qty * (900 + (pk % 1000) / 10 + 100 * (pk % 10)), 2)
    ship = lod + rng.integers(1, 122, n).astype(np.int32)
    commit = lod + rng.integers(30, 91, n).astype(np.int32)
    receipt = ship + rng.integers(1, 31, n).astype(np.int32)
    returnflag = np.where(
        receipt <= (np.datetime64("1995-06-17") - DATE_EPOCH).astype(np.int32),
        rng.choice(["R", "A"], n),
        "N",
    )
    linestatus = np.where(
        ship > (np.datetime64("1995-06-17") - DATE_EPOCH).astype(np.int32), "O", "F"
    )
    return pa.table(
        {
            "l_orderkey": lok,
            "l_partkey": pk,
            "l_suppkey": sk,
            "l_linenumber": linenumber.astype(np.int32),
            "l_quantity": qty,
            "l_extendedprice": extprice,
            "l_discount": np.round(rng.integers(0, 11, n) / 100.0, 2),
            "l_tax": np.round(rng.integers(0, 9, n) / 100.0, 2),
            "l_returnflag": pa.array(returnflag),
            "l_linestatus": pa.array(linestatus),
            "l_shipdate": pa.array(ship, type=pa.date32()),
            "l_commitdate": pa.array(commit, type=pa.date32()),
            "l_receiptdate": pa.array(receipt, type=pa.date32()),
            "l_shipinstruct": _take(INSTRUCTIONS, rng.integers(0, 4, n)),
            "l_shipmode": _take(SHIPMODES, rng.integers(0, 7, n)),
            "l_comment": _comments(rng, n),
        },
        schema=get_tpch_schema("lineitem"),
    )


def write_partitioned(table: pa.Table, out_dir: str, name: str, parts: int) -> None:
    d = os.path.join(out_dir, name)
    os.makedirs(d, exist_ok=True)
    n = table.num_rows
    parts = max(1, min(parts, n))
    step = (n + parts - 1) // parts
    for p in range(parts):
        chunk = table.slice(p * step, step)
        pq.write_table(chunk, os.path.join(d, f"part-{p:03d}.parquet"))


# per-chunk generation caps (keys per chunk): bound peak memory so SF=100
# streams to parquet instead of materializing ~600M lineitem rows at once
# (the reference's dbgen also streams, rust/benchmarks/tpch/tpch-gen.sh)
_CHUNK_KEYS = {
    "part": 4_000_000,
    "partsupp": 1_000_000,  # part-key space: 4 rows per key
    "customer": 4_000_000,
    "orders": 2_000_000,  # ~4x lineitem rows ride along per chunk
}


def _chunk_plan(name: str, total: int, parts: int) -> List[tuple]:
    """(k, lo, n, subsplit) of each chunk of `total` keys of table `name`.
    Chunking depends ONLY on the table's cap, never on `parts`, so the DATA
    is deterministic for a given (seed, sf); `parts` only controls the file
    layout (generated chunks are sliced into sub-files when fewer chunks
    than parts exist)."""
    cap = _CHUNK_KEYS[name]
    n_chunks = max(1, -(-total // cap))
    step = -(-total // n_chunks)
    subsplit = max(1, -(-max(1, parts) // n_chunks))
    out = []
    for k in range(n_chunks):
        lo = k * step
        n = min(step, total - lo)
        if n <= 0:
            break
        out.append((k, lo, n, subsplit))
    return out


def _write_chunk(out_dir: str, name: str, sf: float, seed: int, k: int, lo: int,
                 n: int, ss: int) -> None:
    """Generate and write chunk k of table `name` (orders carry their
    lineitem rows), seeded from rng([seed, tag, k])."""
    import zlib

    d = os.path.join(out_dir, name)
    tag = zlib.crc32(name.encode())  # stable across processes (hash() is not)
    r = np.random.default_rng([seed, tag, k])
    if name == "part":
        _write_split(gen_part(sf, r, lo, n), d, k, ss)
    elif name == "partsupp":
        _write_split(gen_partsupp(sf, r, lo, n), d, k, ss)
    elif name == "customer":
        _write_split(gen_customer(sf, r, lo, n), d, k, ss)
    else:
        # orders + lineitem ride the same chunk (lineitem rows derive from
        # the chunk's orders)
        o = gen_orders(sf, r, lo, n)
        _write_split(o, d, k, ss)
        _write_split(gen_lineitem(sf, r, o), os.path.join(out_dir, "lineitem"), k, ss)


def _write_chunk_args(args: tuple) -> None:
    _write_chunk(*args)


def _write_split(table: pa.Table, d: str, k: int, subsplit: int) -> None:
    rows = table.num_rows
    ss = min(subsplit, max(1, rows))
    sstep = -(-rows // ss)
    for s in range(ss):
        chunk = table.slice(s * sstep, sstep)
        if chunk.num_rows:
            pq.write_table(chunk, os.path.join(d, f"part-{k:03d}-{s:02d}.parquet"))


def generate(out_dir: str, sf: float = 0.01, parts: int = 2, seed: int = 20260728,
             workers: int = 1) -> None:
    """Write the eight tables under `out_dir`, one directory each, and a
    `_SUCCESS` marker last. With workers > 1 the chunks are written by that
    many spawned processes; the files are the same bytes either way."""
    import shutil

    os.makedirs(out_dir, exist_ok=True)
    # start clean: scans glob every *.parquet under a table dir, so files
    # surviving from an interrupted or older-layout run would silently
    # duplicate rows in the regenerated dataset
    marker = os.path.join(out_dir, "_SUCCESS")
    if os.path.exists(marker):
        os.remove(marker)
    for t in TPCH_TABLES:
        shutil.rmtree(os.path.join(out_dir, t), ignore_errors=True)
        os.makedirs(os.path.join(out_dir, t))
    rng = np.random.default_rng(seed)
    write_partitioned(gen_region(), out_dir, "region", 1)
    write_partitioned(gen_nation(), out_dir, "nation", 1)
    write_partitioned(gen_supplier(sf, rng), out_dir, "supplier", 1)

    totals = {"part": max(1, int(200_000 * sf)), "partsupp": max(1, int(200_000 * sf)),
              "customer": max(1, int(150_000 * sf)),
              "orders": max(1, int(1_500_000 * sf))}
    # largest first, so that the pool's last task is a small one
    tasks = [(out_dir, name, sf, seed, *chunk)
             for name in ("orders", "part", "partsupp", "customer")
             for chunk in _chunk_plan(name, totals[name], parts)]
    if workers <= 1:
        for t in tasks:
            _write_chunk(*t)
    else:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(min(workers, len(tasks))) as pool:
            for _ in pool.imap_unordered(_write_chunk_args, tasks):
                pass
    # completeness marker: consumers must not mistake an interrupted run
    # for a dataset
    with open(os.path.join(out_dir, "_SUCCESS"), "w") as f:
        f.write(f"sf={sf} parts={parts} seed={seed}\n")


def is_complete(out_dir: str) -> bool:
    return os.path.exists(os.path.join(out_dir, "_SUCCESS"))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=0.01)
    ap.add_argument("--out", required=True)
    ap.add_argument("--parts", type=int, default=2)
    ap.add_argument("--seed", type=int, default=20260728)
    ap.add_argument("--workers", type=int, default=1)
    a = ap.parse_args()
    generate(a.out, a.sf, a.parts, a.seed, a.workers)
    print(f"TPC-H sf={a.sf} written to {a.out}")
