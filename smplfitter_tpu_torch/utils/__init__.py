"""Host-side numpy utilities (model loading, synthetic models)."""
