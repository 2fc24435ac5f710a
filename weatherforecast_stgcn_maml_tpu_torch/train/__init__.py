"""Serving-side pieces of the training stack (batched eval forward, predict)."""
