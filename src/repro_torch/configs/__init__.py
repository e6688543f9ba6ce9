"""Architecture configurations (copies of the JAX package's, which the port
may not import)."""
