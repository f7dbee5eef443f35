"""q6's substitution parameters (TPC-H v3 clause 2.4.6.3): YEAR within
[1993, 1997], DISCOUNT within [0.02, 0.09] in hundredths, QUANTITY 24 or
25. The template, queries/q6.sql, is benchmarks/tpch/queries/q6.sql at
commit aab2caf with slots for the three. The discount bounds are written
as decimal literals (DISCOUNT - 0.01, DISCOUNT + 0.01), never computed in
binary floating point."""

VALIDATION = {"YEAR": 1994, "DISCOUNT": 6, "QUANTITY": 24}


def space() -> list:
    return [{"YEAR": y, "DISCOUNT": d, "QUANTITY": q}
            for y in range(1993, 1998) for d in range(2, 10) for q in (24, 25)]


def bind(p: dict) -> dict:
    return {"DATE": f"{p['YEAR']}-01-01", "DISCOUNT_LO": f"0.{p['DISCOUNT'] - 1:02d}",
            "DISCOUNT_HI": f"0.{p['DISCOUNT'] + 1:02d}", "QUANTITY": str(p["QUANTITY"])}
