"""Serving engines: forecast and validate."""
