"""Batched codec pipelines on PyTorch tensors (one row per unit), and the
host wrappers that split streams into batches and join the output."""
