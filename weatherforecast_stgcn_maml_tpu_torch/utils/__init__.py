"""Checkpoints and parameter conversion."""
