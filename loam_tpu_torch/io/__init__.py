"""Data sources of the port (NumPy only)."""
