"""Exact GP regression engine and reconstructor of the port."""
