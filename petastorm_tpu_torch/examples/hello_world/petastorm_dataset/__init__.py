"""Hello world over a petastorm store (torch twins)."""
