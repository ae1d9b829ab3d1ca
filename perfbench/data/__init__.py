"""Seeded inputs of the benchmark, made on the device."""
