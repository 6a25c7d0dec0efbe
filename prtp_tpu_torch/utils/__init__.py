"""Weight conversion and metrics."""
