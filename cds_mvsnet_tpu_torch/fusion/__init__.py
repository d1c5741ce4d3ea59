"""Depth-map filtering and fusion into point clouds: on the device (normal) and native C++ (gipuma)."""
