"""Checkpoint save and restore in ``repro.checkpoint``'s file layout."""
