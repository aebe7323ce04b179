"""Hello world over a plain Parquet store (torch twins)."""
