"""Find the benchmark's parts by the names BENCHMARK.json and the cell files
use. Each part is a file of its own, so that a later change adds a
configuration, a workload, a query template, an engine, a traffic mix or a
metric by adding files alone:

- workloads/<cell>.json and configs/<config>.json: data;
- engines/<kind>.py and traffic/<kind>.py: modules, by the `engine` of a
  configuration and the `traffic` of a cell;
- queries/<q>.sql, params/<q>.py and reference/<q>.py: one query template
  with its TPC-H substitution parameters and its plain reference;
- end_to_end/<metric>.py and metrics/<metric>.py: one reader per metric,
  loaded from its file, so that a name may hold a dot; which metrics a
  cell reports is BENCHMARK.json's to say."""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
from collections import namedtuple

ROOT = pathlib.Path(__file__).resolve().parent

# one query of a stream: template name, its parameters (a sorted tuple of
# items, so that equal draws compare equal) and the SQL text
Query = namedtuple("Query", "template params sql")


def workload(name: str) -> dict:
    return json.loads((ROOT / "workloads" / f"{name}.json").read_text())


def config(name: str) -> dict:
    return json.loads((ROOT / "configs" / f"{name}.json").read_text())


def module(kind: str, name: str):
    """perfbench.<kind>.<name> (engines, traffic, params, reference)."""
    return importlib.import_module(f"perfbench.{kind}.{name}")


class Template:
    def __init__(self, name: str) -> None:
        self.name = name
        self.sql = (ROOT / "queries" / f"{name}.sql").read_text()
        self.params = module("params", name)
        self.reference = module("reference", name)

    def query(self, p: dict) -> Query:
        return Query(self.name, tuple(sorted(p.items())),
                     self.sql.format(**self.params.bind(p)))


def metric_names(cell: str, per_layer: bool, spec: dict | None = None) -> list:
    """The names of the cell's end-to-end (or per-layer) metrics in the
    benchmark's spec (BENCHMARK.json beside this folder): those with no
    `workloads` key and those that list the cell."""
    spec = spec or json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    return [m["name"] for m in spec["per_layer" if per_layer else "end_to_end"]
            if cell in m.get("workloads", [cell])]


def reader(name: str, per_layer: bool):
    """The reader of one metric: metrics/<name>.py (per-layer) or
    end_to_end/<name>.py, loaded from its file. It has UNIT and
    read(run) -> a number, or None where it finds nothing to read."""
    kind = "metrics" if per_layer else "end_to_end"
    path = ROOT / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench.{kind}:{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
