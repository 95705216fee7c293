"""Ops of the port: each TPU kernel's Hopper kernel beside its plain
PyTorch version, and the public ops that dispatch between them."""
