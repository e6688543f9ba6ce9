"""Checkpoint save/restore with the exactly-once gate."""
