"""Modules of the port: encoders, update block, RAFTStereo, anytime split."""
