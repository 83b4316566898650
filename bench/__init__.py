"""Benchmark package for the BICOS engine: ``bench/suite.py`` runs the
per-stage and integration measurement matrix on a GPU."""
