"""Plain PyTorch answers, one module per primitive: `solve(graph, root)`
gives what a correct call returns, `compare(answer, expected)` the
numbers that decide `correct` (each with the limit `LIMITS` gives),
`control(graph, root)` the answer with one stated guarantee broken.
They import nothing of the program."""
