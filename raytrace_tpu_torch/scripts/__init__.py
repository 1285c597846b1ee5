"""Entry points of the port that mirror the JAX package's ``scripts/``."""
