"""The TPC-H parameter draws of the traffic mixes: reproducible for a
seed, inside the specification's ranges (clause 2.4), and without
replacement across streams until a template's space is used up."""

import collections
import datetime

import pytest

from perfbench import catalog
from perfbench.run import seed_rng

TEMPLATES = ["q1", "q3", "q5", "q6", "q10", "q12"]
SEED = 3_000_000_017  # past 2**31, as the benchmark's seeds may be


def _make(kind, seed, streams):
    templates = [catalog.Template(q) for q in TEMPLATES]
    return catalog.module("traffic", kind).make({"streams": streams}, templates,
                                                seed_rng(seed, 1))


@pytest.mark.parametrize("kind", ["repeat_stream", "fresh_streams"])
def test_draws_repeat_for_a_seed_and_differ_across_seeds(kind):
    a, b, c = _make(kind, SEED, 2), _make(kind, SEED, 2), _make(kind, SEED + 1, 2)
    assert a == b
    assert [s[:60] for s in a[1]] != [s[:60] for s in c[1]]


def _in_range(template, p):
    if template == "q1":
        return 60 <= p["DELTA"] <= 120
    if template == "q3":
        d = datetime.date(1995, 3, p["DAY"])
        return p["SEGMENT"] in {"AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY",
                                "HOUSEHOLD"} and d.month == 3
    if template == "q5":
        return p["REGION"] in {"AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"} \
            and 1993 <= p["YEAR"] <= 1997
    if template == "q6":
        return 1993 <= p["YEAR"] <= 1997 and 2 <= p["DISCOUNT"] <= 9 and p["QUANTITY"] in (24, 25)
    if template == "q10":
        y, m = map(int, p["MONTH"].split("-"))
        return (1993, 2) <= (y, m) <= (1995, 1)
    if template == "q12":
        modes = {"REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"}
        return p["SHIPMODE1"] in modes and p["SHIPMODE2"] in modes \
            and p["SHIPMODE1"] != p["SHIPMODE2"] and 1993 <= p["YEAR"] <= 1997
    raise AssertionError(template)


@pytest.mark.parametrize("template", TEMPLATES)
def test_space_lies_inside_the_specification(template):
    t = catalog.Template(template)
    space = t.params.space()
    assert t.params.VALIDATION in space
    assert len({tuple(sorted(p.items())) for p in space}) == len(space)
    assert all(_in_range(template, p) for p in space)
    q = t.query(t.params.VALIDATION)
    assert "{" not in q.sql


def test_the_validation_queries_are_the_old_query_files():
    """Bound to the validation parameters, each template is its query file
    under benchmarks/tpch/queries (read as text; nothing is imported)."""
    import pathlib

    old = pathlib.Path(catalog.ROOT).parent / "benchmarks" / "tpch" / "queries"
    for name in TEMPLATES:
        t = catalog.Template(name)
        want = (old / f"{name}.sql").read_text()
        got = t.query(t.params.VALIDATION).sql
        if name == "q1":  # DATE stands for 1998-12-01 - 90 days
            assert got == want
        else:
            assert got == want, name


def test_fresh_streams_draw_without_replacement_until_the_space_is_used():
    """Each stream draws its own share of a template's space (every n-th
    of one seeded permutation): the shares are disjoint, a stream repeats
    nothing within its share, and it cycles through the same share."""
    warmup, streams = _make("fresh_streams", SEED, 2)
    validation = set(warmup)
    sizes = {t: len(catalog.Template(t).params.space()) - 1 for t in TEMPLATES}
    shares = []
    for i, s in enumerate(streams):
        per = collections.defaultdict(list)
        for q in s:
            assert q not in validation
            per[q.template].append(q)
        share = {}
        for t, qs in per.items():
            n = -(-(sizes[t] - i) // 2)  # this stream's share: every 2nd from i
            assert len(set(qs[:n])) == n, t
            assert set(qs) == set(qs[:n]), t
            share[t] = set(qs[:n])
        shares.append(share)
    for t in TEMPLATES:
        assert not shares[0][t] & shares[1][t]
        assert len(shares[0][t] | shares[1][t]) == sizes[t]


def test_repeat_stream_runs_one_round_again_and_again():
    warmup, (stream,) = _make("repeat_stream", SEED, 1)
    assert sorted(q.template for q in warmup) == sorted(TEMPLATES)
    assert stream[:6] == warmup and stream[6:12] == warmup
