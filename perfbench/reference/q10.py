"""q10, returned item reporting: revenue lost to returned lineitems per
customer over one quarter, the twenty largest, with the customer's
details. The answer holds MARGIN more rows in order, so that the
comparison can tell a tie at the twentieth row from a wrong one."""

import numpy as np

from perfbench.params.q10 import bind
from perfbench.reference.tables import add_months, day, group_sum

KEYS = ["c_custkey"]
ORDER = [("revenue", True)]
LIMIT = 20
MARGIN = 20


def answer(t, p: dict) -> dict:
    b = bind(p)
    lo, hi = day(b["DATE"]), day(add_months(b["DATE"], 3))
    o_date = t.col("orders", "o_orderdate")
    o_ok = (o_date >= lo) & (o_date < hi)
    o_cust_row = t.lookup("customer", "c_custkey", t.col("orders", "o_custkey"))
    o_row = t.lookup("orders", "o_orderkey", t.col("lineitem", "l_orderkey"))
    m = t.is_in("lineitem", "l_returnflag", ["R"]) & (o_row >= 0)
    m[m] = o_ok[o_row[m]] & (o_cust_row[o_row[m]] >= 0)
    g = o_cust_row[o_row[m]]
    price = t.col("lineitem", "l_extendedprice")[m]
    disc = t.col("lineitem", "l_discount")[m]
    n = len(t.col("customer", "c_custkey"))
    revenue = group_sum(g, price * (t.one(1) - disc), n)
    hit = np.nonzero(np.bincount(g, minlength=n))[0]
    top = hit[np.argsort(-revenue[hit], kind="stable")[:LIMIT + MARGIN]]
    nation_row = t.lookup("nation", "n_nationkey", t.col("customer", "c_nationkey")[top])
    return {
        "c_custkey": t.col("customer", "c_custkey")[top].astype(np.int64),
        "c_name": t.strings("customer", "c_name", top),
        "revenue": revenue[top],
        "c_acctbal": t.col("customer", "c_acctbal")[top],
        "n_name": t.strings("nation", "n_name", nation_row),
        "c_address": t.strings("customer", "c_address", top),
        "c_phone": t.strings("customer", "c_phone", top),
        "c_comment": t.strings("customer", "c_comment", top),
    }
