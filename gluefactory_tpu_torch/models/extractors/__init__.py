"""Keypoint extractors."""
