"""Env-sharded data parallel (counterpart of the JAX package's ``parallel/``)."""
