"""Checkpoint files and conversions into the port's state dicts."""
