"""Data path of the port: records, the slot parser, the in-memory slot
dataset, CSR batch assembly, the columnar file reader, the Criteo
reader."""
