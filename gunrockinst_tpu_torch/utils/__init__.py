"""Host surfaces: the CLI's flags (`config`) and the INST layer
(`instrument`)."""
