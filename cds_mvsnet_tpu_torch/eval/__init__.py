"""The eval product's inference step: depth, confidence, cam and image files per view."""
