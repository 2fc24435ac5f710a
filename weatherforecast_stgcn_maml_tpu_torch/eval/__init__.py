"""Forecast metrics."""
