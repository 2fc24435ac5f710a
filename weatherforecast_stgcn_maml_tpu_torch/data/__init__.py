"""Host-side data: regions, time features, synthetic fields, features, windows."""
