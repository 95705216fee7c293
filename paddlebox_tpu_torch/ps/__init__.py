"""Embedding tables of the port: the serving table, the host table (the
DRAM tier and its sparse optimizers), the device-resident table of the
training path and the tiered table over the two."""
