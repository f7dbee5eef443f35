"""The plain reference: one NumPy function per TPC-H template, over columns
it reads itself from the benchmark's Parquet files. It imports nothing of
the program; its answers decide `correct` (perfbench/compare.py)."""
