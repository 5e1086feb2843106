"""Optimizers: AdamW with optional int8 moments (``adamw``)."""
