"""Fixtures of the benchmark's CPU tests: one tiny TPC-H database (SF
0.01) shared by the tests of a session."""

import pytest

from perfbench.tpch.datagen import generate

SF = 0.01


@pytest.fixture(scope="session")
def tiny_db(tmp_path_factory):
    d = tmp_path_factory.mktemp("tpch") / "db"
    generate(str(d), SF, 2, 20260728)
    return str(d)
