"""Plain references of the benchmark's configurations (float64 PyTorch;
nothing of the program under test)."""
