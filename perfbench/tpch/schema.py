"""TPC-H table schemas (frozen copy of benchmarks/tpch/schema.py at commit aab2caf).

Mirrors the reference's inline schema definitions
(rust/benchmarks/tpch/src/main.rs:267-360). DECIMAL columns are float64 here:
the engine's numeric tower is TPU-first (bf16/f32/f64), and the reference's
own CSV path reads decimals as floats too.
"""

import pyarrow as pa

TPCH_TABLES = [
    "part", "supplier", "partsupp", "customer", "orders", "lineitem",
    "nation", "region",
]


def get_tpch_schema(table: str) -> pa.Schema:
    f = pa.field
    if table == "part":
        return pa.schema([
            f("p_partkey", pa.int64()),
            f("p_name", pa.string()),
            f("p_mfgr", pa.string()),
            f("p_brand", pa.string()),
            f("p_type", pa.string()),
            f("p_size", pa.int32()),
            f("p_container", pa.string()),
            f("p_retailprice", pa.float64()),
            f("p_comment", pa.string()),
        ])
    if table == "supplier":
        return pa.schema([
            f("s_suppkey", pa.int64()),
            f("s_name", pa.string()),
            f("s_address", pa.string()),
            f("s_nationkey", pa.int64()),
            f("s_phone", pa.string()),
            f("s_acctbal", pa.float64()),
            f("s_comment", pa.string()),
        ])
    if table == "partsupp":
        return pa.schema([
            f("ps_partkey", pa.int64()),
            f("ps_suppkey", pa.int64()),
            f("ps_availqty", pa.int32()),
            f("ps_supplycost", pa.float64()),
            f("ps_comment", pa.string()),
        ])
    if table == "customer":
        return pa.schema([
            f("c_custkey", pa.int64()),
            f("c_name", pa.string()),
            f("c_address", pa.string()),
            f("c_nationkey", pa.int64()),
            f("c_phone", pa.string()),
            f("c_acctbal", pa.float64()),
            f("c_mktsegment", pa.string()),
            f("c_comment", pa.string()),
        ])
    if table == "orders":
        return pa.schema([
            f("o_orderkey", pa.int64()),
            f("o_custkey", pa.int64()),
            f("o_orderstatus", pa.string()),
            f("o_totalprice", pa.float64()),
            f("o_orderdate", pa.date32()),
            f("o_orderpriority", pa.string()),
            f("o_clerk", pa.string()),
            f("o_shippriority", pa.int32()),
            f("o_comment", pa.string()),
        ])
    if table == "lineitem":
        return pa.schema([
            f("l_orderkey", pa.int64()),
            f("l_partkey", pa.int64()),
            f("l_suppkey", pa.int64()),
            f("l_linenumber", pa.int32()),
            f("l_quantity", pa.float64()),
            f("l_extendedprice", pa.float64()),
            f("l_discount", pa.float64()),
            f("l_tax", pa.float64()),
            f("l_returnflag", pa.string()),
            f("l_linestatus", pa.string()),
            f("l_shipdate", pa.date32()),
            f("l_commitdate", pa.date32()),
            f("l_receiptdate", pa.date32()),
            f("l_shipinstruct", pa.string()),
            f("l_shipmode", pa.string()),
            f("l_comment", pa.string()),
        ])
    if table == "nation":
        return pa.schema([
            f("n_nationkey", pa.int64()),
            f("n_name", pa.string()),
            f("n_regionkey", pa.int64()),
            f("n_comment", pa.string()),
        ])
    if table == "region":
        return pa.schema([
            f("r_regionkey", pa.int64()),
            f("r_name", pa.string()),
            f("r_comment", pa.string()),
        ])
    raise ValueError(f"unknown TPC-H table {table!r}")
