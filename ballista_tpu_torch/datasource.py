"""Table sources (scans).

The reference scans CSV / Parquet / in-memory tables through DataFusion's
TableProvider + the DFTableAdapter bridge (reference rust/core/src/datasource.rs:28-66).
Here a TableSource is a lightweight descriptor: schema + file list; the
physical layer turns it into scan operators, and partition count = file count
(the reference's per-file partitioning for CSV/Parquet directories).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import pyarrow as pa
import pyarrow.csv
import pyarrow.parquet

from ballista_tpu_torch.errors import IoError, PlanError


def _discover_files(path: str, suffix: str) -> List[str]:
    """A path is a single file or a directory of part-files (reference
    behavior of DataFusion's file scan for directories)."""
    if os.path.isfile(path):
        return [path]
    if os.path.isdir(path):
        files = sorted(
            os.path.join(path, f)
            for f in os.listdir(path)
            if f.endswith(suffix) and not f.startswith(".")
        )
        if not files:
            raise IoError(f"no *{suffix} files under {path}")
        return files
    raise IoError(f"no such path: {path}")


class TableSource:
    """Base descriptor for a scannable table."""

    def schema(self) -> pa.Schema:
        raise NotImplementedError

    def num_partitions(self) -> int:
        raise NotImplementedError

    def table_type(self) -> str:
        raise NotImplementedError


class CsvTableSource(TableSource):
    def __init__(
        self,
        path: str,
        schema: Optional[pa.Schema] = None,
        has_header: bool = True,
        delimiter: str = ",",
        file_extension: str = ".csv",
    ) -> None:
        self.path = path
        self.has_header = has_header
        self.delimiter = delimiter
        self.file_extension = file_extension
        self.files = _discover_files(path, file_extension)
        if schema is None:
            schema = self._infer_schema()
        self._schema = schema

    def _infer_schema(self) -> pa.Schema:
        read_opts = pa.csv.ReadOptions(autogenerate_column_names=not self.has_header)
        parse_opts = pa.csv.ParseOptions(delimiter=self.delimiter)
        table = pa.csv.read_csv(
            self.files[0], read_options=read_opts, parse_options=parse_opts
        )
        return table.schema

    def schema(self) -> pa.Schema:
        return self._schema

    def num_partitions(self) -> int:
        return len(self.files)

    def table_type(self) -> str:
        return "csv"


class ParquetTableSource(TableSource):
    def __init__(self, path: str, file_extension: str = ".parquet") -> None:
        self.path = path
        self.files = _discover_files(path, file_extension)
        self._schema = pa.parquet.read_schema(self.files[0])

    def schema(self) -> pa.Schema:
        return self._schema

    def num_partitions(self) -> int:
        return len(self.files)

    def table_type(self) -> str:
        return "parquet"


class MemoryTableSource(TableSource):
    """In-memory table: a list of record-batch lists, one list per partition."""

    def __init__(self, schema: pa.Schema, partitions: List[List[pa.RecordBatch]]) -> None:
        self._schema = schema
        self.partitions = partitions

    @classmethod
    def from_table(cls, table: pa.Table, n_partitions: int = 1) -> "MemoryTableSource":
        batches = table.to_batches()
        if 1 < n_partitions and len(batches) < n_partitions and table.num_rows:
            # a single-chunk table would otherwise land whole in partition 0
            # and leave the rest empty — split rows evenly instead
            chunk = -(-table.num_rows // n_partitions)
            batches = table.combine_chunks().to_batches(max_chunksize=chunk)
        parts: List[List[pa.RecordBatch]] = [[] for _ in range(n_partitions)]
        for i, b in enumerate(batches):
            parts[i % n_partitions].append(b)
        return cls(table.schema, parts)

    def schema(self) -> pa.Schema:
        return self._schema

    def num_partitions(self) -> int:
        return len(self.partitions)

    def table_type(self) -> str:
        return "memory"


def make_source(table_type: str, path: str, options: Dict[str, Any]) -> TableSource:
    """Rebuild a source from serialized descriptor fields (serde path)."""
    if table_type == "csv":
        schema = options.get("schema")
        return CsvTableSource(
            path,
            schema=schema,
            has_header=options.get("has_header", True),
            delimiter=options.get("delimiter", ","),
            file_extension=options.get("file_extension", ".csv"),
        )
    if table_type == "parquet":
        return ParquetTableSource(path, file_extension=options.get("file_extension", ".parquet"))
    raise PlanError(f"unknown table type {table_type!r}")
