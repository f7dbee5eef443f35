"""q5, local supplier volume: revenue of the lineitems whose customer and
supplier are of the same nation, per nation of one region, in one year."""

import numpy as np

from perfbench.params.q5 import bind
from perfbench.reference.tables import add_months, day, group_sum

KEYS = ["n_name"]
ORDER = [("revenue", True)]
LIMIT = None


def answer(t, p: dict) -> dict:
    b = bind(p)
    lo, hi = day(b["DATE"]), day(add_months(b["DATE"], 12))
    regions = t.col("region", "r_regionkey")[t.is_in("region", "r_name", [b["REGION"]])]
    n_key = t.col("nation", "n_nationkey")
    n_ok = np.isin(t.col("nation", "n_regionkey"), regions)
    o_date = t.col("orders", "o_orderdate")
    o_ok = (o_date >= lo) & (o_date < hi)
    c_row = t.lookup("customer", "c_custkey", t.col("orders", "o_custkey"))
    c_nation = t.col("customer", "c_nationkey")
    o_nation = np.where(c_row >= 0, c_nation[np.maximum(c_row, 0)], -1)
    o_row = t.lookup("orders", "o_orderkey", t.col("lineitem", "l_orderkey"))
    s_row = t.lookup("supplier", "s_suppkey", t.col("lineitem", "l_suppkey"))
    m = (o_row >= 0) & (s_row >= 0)
    m[m] = o_ok[o_row[m]]
    s_nation = t.col("supplier", "s_nationkey")[s_row[m]]
    same = o_nation[o_row[m]] == s_nation
    nation_row = t.lookup("nation", "n_nationkey", s_nation)
    keep = same & (nation_row >= 0)
    keep[keep] = n_ok[nation_row[keep]]
    m[m] = keep
    g = nation_row[keep]
    price = t.col("lineitem", "l_extendedprice")[m]
    disc = t.col("lineitem", "l_discount")[m]
    revenue = group_sum(g, price * (t.one(1) - disc), len(n_key))
    hit = np.nonzero(np.bincount(g, minlength=len(n_key)))[0]
    hit = hit[np.argsort(-revenue[hit], kind="stable")]
    return {
        "n_name": t.strings("nation", "n_name", hit),
        "revenue": revenue[hit],
    }
