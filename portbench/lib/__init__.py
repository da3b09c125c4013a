"""The benchmark's own arithmetic and inputs: seeded inputs, the load
generator's tiles, the work counted from shapes, the traced window's
reduction, statistics and the import guard."""
