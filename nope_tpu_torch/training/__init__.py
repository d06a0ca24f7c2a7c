"""Checkpoints of the port's modules."""
