"""The harness: files found by name, the generated graph and weights, traces, the import check."""
