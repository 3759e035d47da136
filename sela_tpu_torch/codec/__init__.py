"""Host orchestration (whole files, corpus batches, streams) and the device
encode and decode steps."""
