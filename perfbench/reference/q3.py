"""q3, shipping priority: revenue of the unshipped orders of one market
segment, the ten largest. The answer holds MARGIN more rows in order, so
that the comparison can tell a tie at the tenth row from a wrong one."""

import numpy as np

from perfbench.params.q3 import bind
from perfbench.reference.tables import day, group_sum

KEYS = ["l_orderkey"]
ORDER = [("revenue", True), ("o_orderdate", False)]
LIMIT = 10
MARGIN = 20


def answer(t, p: dict) -> dict:
    b = bind(p)
    d = day(b["DATE"])
    cust = t.col("customer", "c_custkey")[t.is_in("customer", "c_mktsegment", [b["SEGMENT"]])]
    o_key = t.col("orders", "o_orderkey")
    o_cust = t.col("orders", "o_custkey")
    o_date = t.col("orders", "o_orderdate")
    o_ok = (o_date < d) & np.isin(o_cust, cust)
    l_key = t.col("lineitem", "l_orderkey")
    o_row = t.lookup("orders", "o_orderkey", l_key)
    m = (t.col("lineitem", "l_shipdate") > d) & (o_row >= 0)
    m[m] = o_ok[o_row[m]]
    price = t.col("lineitem", "l_extendedprice")[m]
    disc = t.col("lineitem", "l_discount")[m]
    rows = o_row[m]
    n = len(o_key)
    revenue = group_sum(rows, price * (t.one(1) - disc), n)
    hit = np.nonzero(np.bincount(rows, minlength=n))[0]
    order = np.lexsort((o_date[hit], -revenue[hit]))[:LIMIT + MARGIN]
    top = hit[order]
    return {
        "l_orderkey": o_key[top].astype(np.int64),
        "revenue": revenue[top],
        "o_orderdate": o_date[top].astype(np.int64),
        "o_shippriority": t.col("orders", "o_shippriority")[top].astype(np.int64),
    }
