"""Graph generators, one module per `generator` named in a
configuration: `make(config, seed, device) -> BenchGraph`."""
