"""Engines: meta-training, adaptation, validation, forecasting, the pipeline."""
