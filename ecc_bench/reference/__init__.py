"""Plain float32 references the benchmark judges the program against.

They import ``torch`` and the standard library only: nothing of the
program, and neither ``jax`` nor the JAX package.
"""
