"""q12, shipping modes and order priority: per ship mode of two, the
lineitems received late in one year whose order was urgent or high
priority, and the others."""

import numpy as np

from perfbench.params.q12 import bind
from perfbench.reference.tables import add_months, day

KEYS = ["l_shipmode"]
ORDER = [("l_shipmode", False)]
LIMIT = None


def answer(t, p: dict) -> dict:
    b = bind(p)
    modes = [b["SHIPMODE1"], b["SHIPMODE2"]]
    ship = t.col("lineitem", "l_shipdate")
    commit = t.col("lineitem", "l_commitdate")
    receipt = t.col("lineitem", "l_receiptdate")
    o_row = t.lookup("orders", "o_orderkey", t.col("lineitem", "l_orderkey"))
    m = (t.is_in("lineitem", "l_shipmode", modes) & (commit < receipt) & (ship < commit)
         & (receipt >= day(b["DATE"])) & (receipt < day(add_months(b["DATE"], 12)))
         & (o_row >= 0))
    high = t.is_in("orders", "o_orderpriority", ["1-URGENT", "2-HIGH"])[o_row[m]]
    codes, values = t.codes("lineitem", "l_shipmode")
    g = codes[m]
    hi = np.bincount(g[high], minlength=len(values))
    lo = np.bincount(g[~high], minlength=len(values))
    hit = sorted((values[i], i) for i in range(len(values)) if hi[i] + lo[i])
    idx = np.asarray([i for _, i in hit], dtype=np.int64)
    return {
        "l_shipmode": [v for v, _ in hit],
        "high_line_count": hi[idx].astype(np.int64),
        "low_line_count": lo[idx].astype(np.int64),
    }
