"""Micro-benchmarks of the port: the counterparts of ``benchmarks/``."""
