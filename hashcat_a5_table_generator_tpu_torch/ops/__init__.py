"""Host plan, schema, block-index, hash, membership and kernel-wrapper
layers of the PyTorch/CUDA package."""
