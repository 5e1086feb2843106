"""Compressed device-resident column store (paper §5-6): dense, bit-packed
(BCA) and dictionary-packed columns, and the policy that picks one per column.
The durability layer (integrity manifests, snapshots) comes with ROADMAP Queue
1 item 11."""
from .columns import (  # noqa: F401
    DenseColumn,
    DeviceColumn,
    DictPackedColumn,
    PackedColumn,
)
from .policy import (  # noqa: F401
    build_device_column,
    choose_device_encoding,
    column_uniques,
    device_space_report,
    resolve_device_encoding,
)
