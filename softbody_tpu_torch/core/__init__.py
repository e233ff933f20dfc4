"""State and scene records (dataclasses / NamedTuples of torch tensors)."""
