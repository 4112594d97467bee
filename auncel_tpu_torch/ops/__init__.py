"""Distance, top-k and k-means primitives."""
