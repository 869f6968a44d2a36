"""Language models that consume SAGe's k-mer tokens (the SSM family so far)."""
