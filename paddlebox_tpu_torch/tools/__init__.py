"""Measurement tools of the port; each runs as ``python3 -m``."""
