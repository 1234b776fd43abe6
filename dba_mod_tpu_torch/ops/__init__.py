"""Numeric ops: losses, SGD schedules, triggers, the fused update kernel,
aggregation."""
