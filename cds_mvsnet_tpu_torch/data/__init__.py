"""Eval data: image decode and resize, the eval dataset, the prefetching loader."""
