"""q1's substitution parameter (TPC-H v3 clause 2.4.1.3): DELTA is drawn
within [60, 120] days. The template, queries/q1.sql, is
benchmarks/tpch/queries/q1.sql at commit aab2caf with a slot for the date
that `date '1998-12-01' - interval 'DELTA' day` names."""

import datetime

VALIDATION = {"DELTA": 90}


def space() -> list:
    return [{"DELTA": d} for d in range(60, 121)]


def bind(p: dict) -> dict:
    return {"DATE": str(datetime.date(1998, 12, 1) - datetime.timedelta(days=p["DELTA"]))}
