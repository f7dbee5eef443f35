"""q5's substitution parameters (TPC-H v3 clause 2.4.5.3): REGION is one of
the five regions, YEAR within [1993, 1997]. The template, queries/q5.sql,
is benchmarks/tpch/queries/q5.sql at commit aab2caf with slots for both."""

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
VALIDATION = {"REGION": "ASIA", "YEAR": 1994}


def space() -> list:
    return [{"REGION": r, "YEAR": y} for r in REGIONS for y in range(1993, 1998)]


def bind(p: dict) -> dict:
    return {"REGION": p["REGION"], "DATE": f"{p['YEAR']}-01-01"}
