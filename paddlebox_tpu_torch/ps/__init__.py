"""Embedding tables of the port: the serving table, the host table (the
DRAM tier and its sparse optimizers), the device-resident table of the
training path, the tiered table over the two, and the device-sharded
table of the mesh engine."""
