"""Host graph containers and generators (NumPy), without JAX."""
