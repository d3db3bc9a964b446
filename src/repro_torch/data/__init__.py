"""Deterministic synthetic training data (``pipeline.SyntheticLM``)."""
