"""Counterpart of the JAX package's same-named subpackage."""
