from .backend import StorageBackend, PosixStorage, MemoryStorage, make_storage
from .gcs import GcsStorage, parse_gs_url
from .custom import CustomStorage, CustomStream, FilesStorage, FilesStream
from .database import Database
from .metadata import (ColumnDescriptor, ColumnType, DatabaseMetadata,
                       TableDescriptor, VideoDescriptor)

__all__ = [
    "StorageBackend", "PosixStorage", "MemoryStorage", "make_storage",
    "GcsStorage", "parse_gs_url",
    "Database", "CustomStorage", "CustomStream", "FilesStorage",
    "FilesStream", "ColumnDescriptor", "ColumnType", "DatabaseMetadata",
    "TableDescriptor", "VideoDescriptor",
]
