"""Fault-tolerant checkpointing."""
