"""Embedding tables of the port: the host table's serving subset and the
device-resident table of the training path."""
