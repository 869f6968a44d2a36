"""PyTorch/CUDA port of the SAGe system (see src/repro for the JAX reference)."""
