"""Linear-algebra and Gram-matrix building blocks of the port."""
