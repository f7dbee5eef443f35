"""q6, forecasting revenue change: one sum over the lineitems of one year
within a discount band and under a quantity."""

import numpy as np

from perfbench.params.q6 import bind
from perfbench.reference.tables import add_months, day, group_sum

KEYS: list = []
ORDER = None
LIMIT = None


def answer(t, p: dict) -> dict:
    b = bind(p)
    ship = t.col("lineitem", "l_shipdate")
    disc = t.col("lineitem", "l_discount")
    m = ((ship >= day(b["DATE"])) & (ship < day(add_months(b["DATE"], 12)))
         & (disc >= t.one(float(b["DISCOUNT_LO"]))) & (disc <= t.one(float(b["DISCOUNT_HI"])))
         & (t.col("lineitem", "l_quantity") < t.one(float(b["QUANTITY"]))))
    v = t.col("lineitem", "l_extendedprice")[m] * disc[m]
    return {"revenue": group_sum(np.zeros(len(v), dtype=np.int64), v, 1)}
