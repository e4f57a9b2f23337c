"""The benchmark of knowledgegraphembedding_torch: cells, traffic, metrics and the plain reference."""
