"""Embedding tables of the port (the serving subset so far)."""
