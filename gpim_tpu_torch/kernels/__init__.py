"""Covariance functions and constraint bijectors of the port."""
