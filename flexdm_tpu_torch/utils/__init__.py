"""Training utilities: the TensorBoard writer and profiling helpers."""
