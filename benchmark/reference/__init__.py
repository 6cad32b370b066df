"""The plain reference that decides `correct`: plain PyTorch and NumPy,
written from the published description (arXiv:2108.10447) and frozen
here. It imports nothing of the program, of `jax` or of the JAX package,
and takes nothing the program made: it draws its own weights from the
seed and batches the benchmark's corpus itself."""
