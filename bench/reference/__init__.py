"""The plain float32 reference the benchmark holds the program to.

Plain PyTorch and NumPy only: it imports nothing of the program, nor JAX,
nor the JAX package, and reads no weights, caches or tables the program
made.  It draws its weights again from the run's seed and works out what
the program's outputs should be.
"""
