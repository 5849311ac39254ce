"""Anytime engine and the serving front's core."""
