"""Graph primitives on the port's kernels."""
