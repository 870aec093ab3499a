"""What a query needs of the card, from the benchmark's own graph and
the reference's answer: `bytes_of(graph, expected)` per primitive, and
the count of traversed edges (`teps.py`)."""
