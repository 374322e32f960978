"""The plain reference: NumPy and plain PyTorch, independent of the
program (it imports nothing of ``repro_torch``, ``repro`` or ``jax``)."""
