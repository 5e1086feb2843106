"""Crash-safe publication of durable directories (``atomic``)."""
