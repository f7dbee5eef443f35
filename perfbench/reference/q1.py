"""q1, the pricing summary report: sums and means of lineitem rows shipped
on or before DATE, per (l_returnflag, l_linestatus)."""

import numpy as np

from perfbench.params.q1 import bind
from perfbench.reference.tables import day, group_sum

KEYS = ["l_returnflag", "l_linestatus"]
ORDER = [("l_returnflag", False), ("l_linestatus", False)]
LIMIT = None


def answer(t, p: dict) -> dict:
    m = t.col("lineitem", "l_shipdate") <= day(bind(p)["DATE"])
    rf, rf_vals = t.codes("lineitem", "l_returnflag")
    ls, ls_vals = t.codes("lineitem", "l_linestatus")
    g = (rf[m].astype(np.int64) * len(ls_vals) + ls[m])
    n = len(rf_vals) * len(ls_vals)
    qty = t.col("lineitem", "l_quantity")[m]
    price = t.col("lineitem", "l_extendedprice")[m]
    disc = t.col("lineitem", "l_discount")[m]
    tax = t.col("lineitem", "l_tax")[m]
    disc_price = price * (t.one(1) - disc)
    charge = disc_price * (t.one(1) + tax)
    count = np.bincount(g, minlength=n)
    sums = [group_sum(g, v, n) for v in (qty, price, disc_price, charge, disc)]
    groups = [i for i in range(n) if count[i]]
    groups.sort(key=lambda i: (rf_vals[i // len(ls_vals)], ls_vals[i % len(ls_vals)]))
    idx = np.asarray(groups, dtype=np.int64)
    c = count[idx].astype(t.dtype)
    return {
        "l_returnflag": [rf_vals[i // len(ls_vals)] for i in groups],
        "l_linestatus": [ls_vals[i % len(ls_vals)] for i in groups],
        "sum_qty": sums[0][idx],
        "sum_base_price": sums[1][idx],
        "sum_disc_price": sums[2][idx],
        "sum_charge": sums[3][idx],
        "avg_qty": sums[0][idx] / c,
        "avg_price": sums[1][idx] / c,
        "avg_disc": sums[4][idx] / c,
        "count_order": count[idx].astype(np.int64),
    }
