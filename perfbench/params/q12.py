"""q12's substitution parameters (TPC-H v3 clause 2.4.12.3): SHIPMODE1 and
SHIPMODE2 are two different ship modes, YEAR within [1993, 1997]. The two
modes form an unordered pair: `l_shipmode in (a, b)` is the same query as
`in (b, a)`, so each pair is drawn once, in alphabetical order. The template, queries/q12.sql, is
benchmarks/tpch/queries/q12.sql at commit aab2caf with slots for the
three."""

SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
VALIDATION = {"SHIPMODE1": "MAIL", "SHIPMODE2": "SHIP", "YEAR": 1994}


def space() -> list:
    modes = sorted(SHIPMODES)
    return [{"SHIPMODE1": a, "SHIPMODE2": b, "YEAR": y}
            for i, a in enumerate(modes) for b in modes[i + 1:]
            for y in range(1993, 1998)]


def bind(p: dict) -> dict:
    return {"SHIPMODE1": p["SHIPMODE1"], "SHIPMODE2": p["SHIPMODE2"],
            "DATE": f"{p['YEAR']}-01-01"}
