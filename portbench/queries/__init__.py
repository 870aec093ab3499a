"""Primitive adaptors, one per `primitive` a traffic mix names:
`call(csr, root, args, device) -> (answer, stats)`, the program's entry
point as a caller uses it, with NumPy arrays back on the host and the
program's own `Stats`.  These are the only modules of the benchmark
that import the program."""
