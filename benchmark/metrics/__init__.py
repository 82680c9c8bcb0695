"""Metric readers, one file a metric, each found by its name."""
