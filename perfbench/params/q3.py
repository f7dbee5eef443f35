"""q3's substitution parameters (TPC-H v3 clause 2.4.3.3): SEGMENT is one
of the five market segments, DATE a day within [1995-03-01, 1995-03-31].
The template, queries/q3.sql, is benchmarks/tpch/queries/q3.sql at commit
aab2caf with slots for both."""

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
VALIDATION = {"SEGMENT": "BUILDING", "DAY": 15}


def space() -> list:
    return [{"SEGMENT": s, "DAY": d} for s in SEGMENTS for d in range(1, 32)]


def bind(p: dict) -> dict:
    return {"SEGMENT": p["SEGMENT"], "DATE": f"1995-03-{p['DAY']:02d}"}
