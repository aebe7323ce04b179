"""Hello world: a petastorm store and a plain Parquet store, read every way (torch twins)."""
