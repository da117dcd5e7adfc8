"""Batch-bucketed CNN serving."""
