"""The fault-tolerant training loop (``loop``)."""
