"""Layers of the port: plain functions on tensors over parameter mappings."""
