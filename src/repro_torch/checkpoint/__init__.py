"""Async, crash-safe checkpoints in the reference's on-disk format
(``store.CheckpointStore``)."""
