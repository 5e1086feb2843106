"""Architecture configs: ``registry.get_arch(<id>)`` → an ``ArchConfig``."""
