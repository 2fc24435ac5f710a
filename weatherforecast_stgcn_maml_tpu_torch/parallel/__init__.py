"""Multi-process helpers (so far only the region-fleet partition)."""
