"""Benchmark runners of the port (run as modules, on the card)."""
