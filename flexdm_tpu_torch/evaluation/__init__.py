"""Evaluation helpers of the port (task masks shared with serving)."""
