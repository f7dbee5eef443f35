"""Columns of the TPC-H tables as NumPy arrays, read straight from the
Parquet files the benchmark wrote (pyarrow decodes the files; all the
arithmetic of the reference is NumPy). Dates are int32 days since
1970-01-01; strings are read as dictionary codes beside their values.

`dtype` is the precision of every float column and of the arithmetic on
it: float64, the schema's, for the reference; float32 for the control
(PERF.md §2), whose grouped sums then accumulate in float32 as well."""

from __future__ import annotations

import datetime
import os

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq

EPOCH = datetime.date(1970, 1, 1)


def day(iso: str) -> int:
    """Days since 1970-01-01 of an ISO date."""
    return (datetime.date.fromisoformat(iso) - EPOCH).days


def add_months(iso: str, months: int) -> str:
    """The ISO date `months` later (SQL's `+ interval 'n' month`; the
    templates add months to the first of a month only)."""
    d = datetime.date.fromisoformat(iso)
    m = d.month - 1 + months
    return d.replace(year=d.year + m // 12, month=m % 12 + 1).isoformat()


class Tables:
    def __init__(self, data_dir: str, dtype=np.float64) -> None:
        self.data_dir = data_dir
        self.dtype = np.dtype(dtype)
        self._cols: dict = {}

    def _read(self, table: str, name: str) -> pa.ChunkedArray:
        t = pq.read_table(os.path.join(self.data_dir, table), columns=[name])
        return t.column(name)

    def col(self, table: str, name: str) -> np.ndarray:
        """A numeric or date column (floats in the reference's dtype)."""
        key = (table, name)
        if key not in self._cols:
            c = self._read(table, name)
            if pa.types.is_date32(c.type):
                a = c.cast(pa.int32()).to_numpy()
            else:
                a = c.to_numpy()
                if a.dtype.kind == "f":
                    a = a.astype(self.dtype, copy=False)
            self._cols[key] = a
        return self._cols[key]

    def codes(self, table: str, name: str):
        """(int32 codes, list of values) of a string column."""
        key = (table, name, "codes")
        if key not in self._cols:
            enc = pc.dictionary_encode(self._read(table, name).combine_chunks())
            self._cols[key] = (enc.indices.to_numpy().astype(np.int32),
                               enc.dictionary.to_pylist())
        return self._cols[key]

    def is_in(self, table: str, name: str, values) -> np.ndarray:
        """Row mask: the string column equals one of `values`."""
        codes, dictionary = self.codes(table, name)
        hit = [i for i, v in enumerate(dictionary) if v in set(values)]
        return np.isin(codes, np.asarray(hit, dtype=np.int32))

    def strings(self, table: str, name: str, rows: np.ndarray) -> list:
        """The values of a string column at `rows`."""
        codes, dictionary = self.codes(table, name)
        return [dictionary[c] for c in codes[rows]]

    def lookup(self, table: str, key: str, keys: np.ndarray) -> np.ndarray:
        """Row index in `table` of each value of `keys` in its key column
        (-1 where absent): a direct-address table over the key's range."""
        k = self.col(table, key)
        top = int(max(k.max(initial=0), keys.max(initial=0))) + 1
        pos = np.full(top, -1, dtype=np.int64)
        pos[k] = np.arange(len(k))
        return pos[keys]

    def one(self, x) -> np.ndarray:
        """A scalar in the reference's dtype."""
        return self.dtype.type(x)


def group_sum(keys: np.ndarray, values: np.ndarray, n: int) -> np.ndarray:
    """Per-group sums of `values` over group ids `keys` in [0, n), in the
    dtype of `values`: a sequential sum per group, in float64 through
    np.bincount, in any other dtype through np.add.at."""
    if values.dtype == np.float64:
        return np.bincount(keys, weights=values, minlength=n)
    out = np.zeros(n, dtype=values.dtype)
    np.add.at(out, keys, values)
    return out
