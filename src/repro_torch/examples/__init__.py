"""Runnable counterparts of the JAX package's examples."""
