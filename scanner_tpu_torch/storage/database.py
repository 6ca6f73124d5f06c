"""Database: table CRUD over a storage backend.

Capability parity: reference scanner/engine/metadata.{h,cpp} (metadata
accessors, megafile) + table_meta_cache.{h,cpp} (TableMetaCache) + the
client-side new_table/table paths (client.py:418-546).

The master process is the single writer of db_metadata; workers only write
item files.  All metadata writes are atomic whole-file replaces.
"""

from __future__ import annotations

import pickle
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Union

from ..common import StorageException
from . import items, metadata as md
from .backend import StorageBackend


class Database:
    def __init__(self, backend: StorageBackend):
        self.backend = backend
        self._meta: Optional[md.DatabaseMetadata] = None
        self._table_cache: Dict[int, md.TableDescriptor] = {}
        self._lock = threading.RLock()

    # -- db metadata --------------------------------------------------------

    @property
    def meta(self) -> md.DatabaseMetadata:
        with self._lock:
            if self._meta is None:
                if self.backend.exists(md.db_meta_path()):
                    self._meta = md.DatabaseMetadata.deserialize(
                        self.backend.read(md.db_meta_path()))
                else:
                    self._meta = md.DatabaseMetadata()
            return self._meta

    def refresh_meta(self) -> md.DatabaseMetadata:
        """Drop caches and re-read metadata from storage (worker side)."""
        with self._lock:
            self._meta = None
            self._table_cache.clear()
            return self.meta

    def save_meta(self) -> None:
        with self._lock:
            self.backend.write(md.db_meta_path(), self.meta.serialize())

    # -- table descriptors --------------------------------------------------

    def table_descriptor(self, table: Union[str, int]) -> md.TableDescriptor:
        with self._lock:
            tid = self.meta.table_id(table) if isinstance(table, str) else table
            if tid not in self._table_cache:
                desc = md.TableDescriptor.deserialize(
                    self.backend.read(md.table_descriptor_path(tid)))
                self._table_cache[tid] = desc
            return self._table_cache[tid]

    def write_table_descriptor(self, desc: md.TableDescriptor) -> None:
        with self._lock:
            self.backend.write(md.table_descriptor_path(desc.id),
                               desc.serialize())
            self._table_cache[desc.id] = desc

    # -- table lifecycle ----------------------------------------------------

    def create_table(self, name: str, columns: Sequence[md.ColumnDescriptor],
                     end_rows: Sequence[int], job_id: int = -1,
                     commit: bool = False) -> md.TableDescriptor:
        """Register a table (uncommitted unless commit=True) and persist its
        descriptor.  Item data is written separately."""
        with self._lock:
            meta = self.meta
            if meta.has_table(name):
                raise StorageException(f"table already exists: {name}")
            tid = meta.add_table(name)
            desc = md.TableDescriptor(
                id=tid, name=name, columns=list(columns),
                end_rows=list(end_rows), job_id=job_id, timestamp=time.time())
            self.write_table_descriptor(desc)
            if commit:
                meta.commit_table(tid)
            self.save_meta()
            return desc

    def delete_table(self, name: str) -> None:
        with self._lock:
            meta = self.meta
            if not meta.has_table(name):
                return
            tid = meta.remove_table(name)
            self._table_cache.pop(tid, None)
            self.save_meta()
            self.backend.delete_prefix(md.table_dir(tid))

    def commit_table(self, table: Union[str, int]) -> None:
        with self._lock:
            tid = self.meta.table_id(table) if isinstance(table, str) else table
            self.meta.commit_table(tid)
            self.save_meta()

    def table_is_committed(self, name: str) -> bool:
        return self.meta.table_is_committed(name)

    def has_table(self, name: str) -> bool:
        return self.meta.has_table(name)

    def list_tables(self) -> List[str]:
        return sorted(self.meta.tables.keys())

    # -- direct data write (client new_table / ingest) ----------------------

    def new_table(self, name: str, columns: Sequence[str],
                  rows: Sequence[Sequence[bytes]],
                  overwrite: bool = False,
                  codecs: Optional[Dict[str, str]] = None
                  ) -> md.TableDescriptor:
        """Create and commit a small table from in-memory rows.

        `rows` is row-major: rows[i][j] is row i of column j — matching the
        reference Client.new_table (client.py:418).  `codecs` maps a
        column to its row codec ("raw" when absent); a "pickle" column
        takes python objects and stores them pickled.
        """
        with self._lock:
            if self.has_table(name):
                if not overwrite:
                    raise StorageException(f"table already exists: {name}")
                self.delete_table(name)
            codecs = codecs or {}
            cols = [md.ColumnDescriptor(c, md.ColumnType.BYTES,
                                        codec=codecs.get(c, "raw"))
                    for c in columns]
            n = len(rows)
            desc = self.create_table(name, cols, end_rows=[n] if n else [],
                                     commit=True)
            for j, cname in enumerate(columns):
                col_rows = [rows[i][j] for i in range(n)]
                if codecs.get(cname) == "pickle":
                    col_rows = [pickle.dumps(r, protocol=pickle.HIGHEST_PROTOCOL)
                                for r in col_rows]
                if n:
                    items.write_item(self.backend,
                                     md.column_item_path(desc.id, cname, 0),
                                     col_rows)
            return desc

    # -- row reads ----------------------------------------------------------

    def load_column(self, table: Union[str, int], column: str,
                    rows: Optional[Sequence[int]] = None,
                    sparsity_threshold: int = 8
                    ) -> Iterator[Optional[bytes]]:
        """Yield serialized rows of a column (None for stored nulls).

        Video columns yield *encoded* data here; frame decode lives in
        storage/streams.py which wraps this with the video layer.
        """
        desc = self._column_desc(table, column)
        return self._load_column_iter(desc, column, rows, sparsity_threshold)

    def read_rows_into(self, table: Union[str, int], column: str,
                       rows: Sequence[int], buf: items.RowBuffer,
                       sparsity_threshold: int = 8
                       ) -> List[Optional[Union[bytes, memoryview]]]:
        """The rows `load_column(table, column, rows)` yields, read into
        `buf` (items.read_item_rows_into): views valid until the next
        read into `buf`, which starts here."""
        desc = self._column_desc(table, column)
        buf.start()
        by_item, order = self._rows_by_item(desc, rows)
        fetched = {
            it: items.read_item_rows_into(
                self.backend, md.column_item_path(desc.id, column, it),
                local, buf, sparsity_threshold)
            for it, local in by_item.items()}
        return [fetched[it][idx] for it, idx in order]

    def _column_desc(self, table, column) -> md.TableDescriptor:
        desc = self.table_descriptor(table)
        if column not in desc.column_names():
            raise StorageException(
                f"table {desc.name} has no column {column} "
                f"(has {desc.column_names()})")
        return desc

    @staticmethod
    def _rows_by_item(desc, rows):
        """Group global rows by item: ({item: [local row, ...]},
        [(item, index into that list)] in request order)."""
        by_item: Dict[int, List[int]] = {}
        order: List[tuple] = []
        for r in rows:
            it = desc.item_of_row(r)
            start, _ = desc.item_bounds(it)
            by_item.setdefault(it, []).append(r - start)
            order.append((it, len(by_item[it]) - 1))
        return by_item, order

    def _load_column_iter(self, desc, column, rows, sparsity_threshold
                          ) -> Iterator[Optional[bytes]]:
        if rows is None:
            for item_idx in range(len(desc.end_rows)):
                path = md.column_item_path(desc.id, column, item_idx)
                yield from items.read_item(self.backend, path)
        else:
            # group requested global rows by item, preserve request order
            by_item, order = self._rows_by_item(desc, list(rows))
            fetched: Dict[int, List[Optional[bytes]]] = {}
            for it, local in by_item.items():
                path = md.column_item_path(desc.id, column, it)
                fetched[it] = items.read_item_rows(
                    self.backend, path, local, sparsity_threshold)
            for it, idx in order:
                yield fetched[it][idx]

    # -- megafile (all table descriptors in one blob) -----------------------

    def write_megafile(self) -> None:
        """Pack every committed table descriptor into one file so cluster
        start-up does one large read instead of N small ones (reference
        write_table_megafile, metadata.cpp)."""
        with self._lock:
            blobs = {}
            for name, tid in self.meta.tables.items():
                if not self.meta.committed.get(tid, False):
                    continue
                try:
                    blobs[str(tid)] = self.table_descriptor(tid).to_dict()
                except StorageException:
                    continue
            self.backend.write(md.megafile_path(), md.pack(blobs))

    def load_megafile(self) -> None:
        with self._lock:
            if not self.backend.exists(md.megafile_path()):
                return
            blobs = md.unpack(self.backend.read(md.megafile_path()))
            for tid_s, d in blobs.items():
                desc = md.TableDescriptor.from_dict(d)
                self._table_cache[desc.id] = desc
