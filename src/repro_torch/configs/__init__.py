"""The port's own copy of the JAX package's model configurations (data:
the published dimensions of every assigned architecture)."""
