"""Step engines of the port (forward half so far)."""
