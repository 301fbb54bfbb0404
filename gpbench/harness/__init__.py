"""The benchmark's general code: traffic generation, the closed loops, the
traced window and one run of a cell."""
