"""q10's substitution parameter (TPC-H v3 clause 2.4.10.3): DATE is the
first of a month from February 1993 to January 1995. The template,
queries/q10.sql, is benchmarks/tpch/queries/q10.sql at commit aab2caf with
a slot for it."""

VALIDATION = {"MONTH": "1993-10"}


def space() -> list:
    months = [(1993 + (m - 1) // 12, (m - 1) % 12 + 1) for m in range(2, 26)]
    return [{"MONTH": f"{y}-{m:02d}"} for y, m in months]


def bind(p: dict) -> dict:
    return {"DATE": f"{p['MONTH']}-01"}
