"""Correlation ops and the CUDA kernel wrappers."""
