"""Streaming video stereo: warm-started anytime refinement across frames."""
