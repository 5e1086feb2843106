"""Compressed device-resident column store (paper §5-6): dense, bit-packed
(BCA) and dictionary-packed columns, and the policy that picks one per
column; plus its durability layer: CRC-32C integrity manifests (hashed on the
card), verified reads, and checksummed generation-stamped snapshots."""
from .columns import (  # noqa: F401
    DenseColumn,
    DeviceColumn,
    DictPackedColumn,
    PackedColumn,
)
from .integrity import (  # noqa: F401
    attach_manifest,
    build_manifest,
    column_digest,
    crc32c,
    crc32c_parts,
    decode_fresh,
    detach_manifest,
    encoded_parts,
    iter_columns,
)
from .policy import (  # noqa: F401
    build_device_column,
    choose_device_encoding,
    column_uniques,
    device_space_report,
    resolve_device_encoding,
)
from .snapshot import (  # noqa: F401
    latest_generation,
    list_generations,
    load_column_arrays,
    restore_db,
    snapshot_db,
)
