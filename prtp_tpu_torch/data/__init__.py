"""Host-side design data for the PyTorch port (numpy only)."""
