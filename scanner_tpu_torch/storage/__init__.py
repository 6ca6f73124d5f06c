from .backend import StorageBackend, PosixStorage, MemoryStorage, make_storage
from .database import Database
from .metadata import (ColumnDescriptor, ColumnType, DatabaseMetadata,
                       TableDescriptor, VideoDescriptor)

# gcs.py and custom.py (GCS and pluggable storage) are not ported yet.
__all__ = [
    "StorageBackend", "PosixStorage", "MemoryStorage", "make_storage",
    "Database", "ColumnDescriptor", "ColumnType", "DatabaseMetadata",
    "TableDescriptor", "VideoDescriptor",
]
