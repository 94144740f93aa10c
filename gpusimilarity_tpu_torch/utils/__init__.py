"""Kernel build/load helpers and conversion from the JAX package's stores."""
