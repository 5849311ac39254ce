"""Geometry, padding and the weight bridge."""
