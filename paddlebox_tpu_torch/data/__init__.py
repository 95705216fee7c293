"""Data path of the port: records, CSR batch assembly, the Criteo reader."""
