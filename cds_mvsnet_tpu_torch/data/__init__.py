"""Data: image decode and resize, the eval dataset, the DTU and BlendedMVS
training readers, the prefetching loader."""
