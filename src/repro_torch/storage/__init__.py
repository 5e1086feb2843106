"""Device-resident column store. This port holds decoded (dense) columns
only; the bit-packed kinds come with ROADMAP Queue 1 item 4."""
from .columns import DenseColumn, DeviceColumn  # noqa: F401
