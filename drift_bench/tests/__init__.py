"""CPU tests of the benchmark (and one that needs a card)."""
