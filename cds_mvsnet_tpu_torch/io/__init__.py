"""File formats of the eval product: PFM maps, cam and pair files, PLY clouds."""
