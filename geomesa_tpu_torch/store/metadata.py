"""Metadata KV: schema registry persistence.

Port of ``geomesa_tpu/store/metadata.py`` (the same JSON registry file, so
either package opens the other's). Rebuild of the reference's GeoMesaMetadata
(geomesa-index-api .../metadata/GeoMesaMetadata.scala:17-100) with in-memory
and JSON-file backends (the analog of InMemoryMetadata and the
catalog-table/ZK backends).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional

from geomesa_tpu_torch.store.integrity import (
    CorruptFileError,
    append_crc_footer,
    cleanup_tmp,
    fsync_replace,
    quarantine,
    read_verified,
)
from geomesa_tpu_torch.utils import deadline, faults, trace
from geomesa_tpu_torch.utils.retry import RetryPolicy


class Metadata:
    """String KV scoped by (type_name, key)."""

    def read(self, type_name: str, key: str) -> Optional[str]:
        raise NotImplementedError

    def insert(self, type_name: str, key: str, value: str) -> None:
        raise NotImplementedError

    def remove(self, type_name: str, key: str) -> None:
        raise NotImplementedError

    def delete(self, type_name: str) -> None:
        raise NotImplementedError

    def scan_types(self) -> List[str]:
        raise NotImplementedError


class InMemoryMetadata(Metadata):
    def __init__(self):
        self._data: Dict[str, Dict[str, str]] = {}
        self._lock = threading.Lock()

    def read(self, type_name, key):
        with self._lock:
            return self._data.get(type_name, {}).get(key)

    def insert(self, type_name, key, value):
        with self._lock:
            self._data.setdefault(type_name, {})[key] = value

    def remove(self, type_name, key):
        with self._lock:
            self._data.get(type_name, {}).pop(key, None)

    def delete(self, type_name):
        with self._lock:
            self._data.pop(type_name, None)

    def scan_types(self):
        with self._lock:
            return sorted(self._data.keys())


class FileMetadata(Metadata):
    """JSON-file backed metadata (single-writer: schema mutation stays with
    one controller).

    Durability: each flush lands via write + CRC32 footer + fsync +
    rename (store/integrity.py), so a crash mid-save can never publish a
    torn registry. A registry that IS torn or corrupt on open (legacy
    stores, disk faults) is quarantined aside — the store opens empty
    instead of refusing to start; re-creating the schemas makes the
    orphaned blocks replayable again on the next open."""

    # a corrupt registry must not be hammered; transient I/O errors and
    # injected faults (OSError) get a few fast attempts
    _SAVE_RETRY = RetryPolicy(
        name="metadata.save", max_attempts=4, base_s=0.005, cap_s=0.1
    )

    def __init__(self, path: str, journal=None):
        self.path = path
        # optional write-ahead intent journal (store/journal.py): the
        # registry flush is a single atomic replace, but routing it
        # through the journal keeps EVERY store mutation uniformly
        # visible to recovery
        self._journal = journal
        self._lock = threading.Lock()
        self._data: Dict[str, Dict[str, str]] = {}
        if os.path.exists(path):
            try:
                self._data = json.loads(read_verified(path).decode())
            except (CorruptFileError, ValueError, UnicodeDecodeError):
                quarantine(path)
                self._data = {}

    def _flush(self):
        with trace.span("metadata.save", path=self.path):
            if self._journal is not None:
                with self._journal.intent("metadata.save",
                                          replaces=[self.path]):
                    self._SAVE_RETRY.call(self._flush_once)
            else:
                self._SAVE_RETRY.call(self._flush_once)

    def _flush_once(self):
        deadline.check("metadata.save")
        faults.fault_point("metadata.save")
        tmp = f"{self.path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w") as fh:
                json.dump(self._data, fh, indent=1, sort_keys=True)
            append_crc_footer(tmp)
            faults.maybe_tear("metadata.save", tmp)
        except Exception:
            # failed flush must not leak its tmp (a BaseException — a
            # crash — leaves it for the startup scrub, like a real crash)
            cleanup_tmp(tmp)
            raise
        fsync_replace(tmp, self.path)

    def read(self, type_name, key):
        with self._lock:
            return self._data.get(type_name, {}).get(key)

    def insert(self, type_name, key, value):
        with self._lock:
            self._data.setdefault(type_name, {})[key] = value
            self._flush()

    def remove(self, type_name, key):
        with self._lock:
            self._data.get(type_name, {}).pop(key, None)
            self._flush()

    def delete(self, type_name):
        with self._lock:
            self._data.pop(type_name, None)
            self._flush()

    def scan_types(self):
        with self._lock:
            return sorted(self._data.keys())
