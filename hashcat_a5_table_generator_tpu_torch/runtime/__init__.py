"""Crack sweeps, length buckets and hit sinks."""
