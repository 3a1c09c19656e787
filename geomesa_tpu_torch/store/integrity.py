"""File integrity for the store tier: CRC footers, quarantine, durable
publish.

Port of ``geomesa_tpu/store/integrity.py``; the footer and the quarantine
names are the reference's, so either package reads the other's files.
The reference trusts HDFS/Accumulo for block integrity; this rebuild's
blocks are plain local files, so corruption detection is the store's own
job. Three pieces:

  * a 16-byte CRC32 footer (``GMCR`` magic + crc + content length)
    appended to npz blocks and ``metadata.json`` at write time and
    verified+stripped at read time — truncation AND bit rot both surface
    as ``CorruptFileError`` instead of garbage columns. Legacy footer-less
    files read unverified.
  * ``quarantine``: a corrupt file is renamed aside to
    ``<name>.quarantine`` (never deleted — operators can inspect or
    repair) and counted in ``robustness_metrics()``; the store keeps
    serving every other block.
  * ``fsync_replace``: flush-to-stable-storage before the rename that
    publishes a file, then fsync the directory entry — a crash between
    write and rename can no longer publish an empty or torn file.
    ``GEOMESA_FS_FSYNC=0`` (or the ``geomesa.fs.fsync`` property) trades
    durability for ingest latency.
"""

from __future__ import annotations

import os
import struct
import sys
import threading
import zlib

from geomesa_tpu_torch.utils.audit import robustness_metrics
from geomesa_tpu_torch.utils.config import SystemProperty

_FOOTER = struct.Struct("<4sIQ")  # magic, crc32(content), len(content)
_MAGIC = b"GMCR"
FOOTER_SIZE = _FOOTER.size

FS_FSYNC = SystemProperty("geomesa.fs.fsync", "1")

QUARANTINE_SUFFIX = ".quarantine"


class CorruptFileError(Exception):
    """Deterministic corruption (CRC mismatch / undecodable content).
    Deliberately NOT an OSError: retry policies must never hammer a
    corrupt file — the caller quarantines it instead."""


def append_crc_footer(path: str) -> None:
    """Append the CRC32 footer to a fully written file (streaming — the
    file is never held in memory)."""
    crc = 0
    size = 0
    with open(path, "rb+") as fh:
        while True:
            chunk = fh.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
        fh.write(_FOOTER.pack(_MAGIC, crc & 0xFFFFFFFF, size))


def verify_bytes(data: bytes, label: str = "<bytes>") -> bytes:
    """Content with the CRC footer (when present) verified and stripped.
    Footer-less data (legacy files) passes through unverified."""
    if len(data) >= FOOTER_SIZE:
        magic, crc, size = _FOOTER.unpack(data[-FOOTER_SIZE:])
        if magic == _MAGIC:
            content = data[:-FOOTER_SIZE]
            if len(content) != size or (zlib.crc32(content) & 0xFFFFFFFF) != crc:
                raise CorruptFileError(f"crc32 mismatch in {label}")
            return content
    return data


def read_verified(path: str) -> bytes:
    """Whole-file read with footer verification (see ``verify_bytes``)."""
    with open(path, "rb") as fh:
        data = fh.read()
    return verify_bytes(data, path)


def verify_file_crc(path: str) -> bool:
    """Streaming footer verification for files read in place by their own
    codec (npz blocks: zipfile tolerates the 16 trailing footer bytes, so
    np.load works on the file directly and the content is never held in
    memory twice). True when a footer was present and matched; False for
    legacy footer-less files; CorruptFileError on any mismatch."""
    size = os.path.getsize(path)
    if size < FOOTER_SIZE:
        return False
    with open(path, "rb") as fh:
        fh.seek(size - FOOTER_SIZE)
        magic, crc, clen = _FOOTER.unpack(fh.read(FOOTER_SIZE))
        if magic != _MAGIC:
            return False
        if clen != size - FOOTER_SIZE:
            raise CorruptFileError(f"crc32 footer length mismatch in {path}")
        fh.seek(0)
        c = 0
        left = clen
        while left:
            chunk = fh.read(min(1 << 20, left))
            if not chunk:
                raise CorruptFileError(f"{path} truncated under verification")
            c = zlib.crc32(chunk, c)
            left -= len(chunk)
        if (c & 0xFFFFFFFF) != crc:
            raise CorruptFileError(f"crc32 mismatch in {path}")
    return True


def fsync_enabled() -> bool:
    return FS_FSYNC.get() not in ("0", "false", "no")


def fsync_dir(path: str) -> None:
    """Fsync a DIRECTORY entry (the step that makes a just-created or
    just-renamed name itself durable), unconditionally — callers gate on
    whichever durability knob governs THEIR boundary (``fsync_enabled``
    for the store tier). Tolerant of filesystems that refuse directory fsync — the
    rename/append stands either way."""
    dfd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)


def cleanup_tmp(tmp: str) -> None:
    """Unlink a temp file, tolerating its absence — the happy-error-path
    companion to ``fsync_replace`` (call from an ``except Exception``
    handler so a failed write never leaks its tmp; a BaseException —
    a real or simulated crash — skips it, leaving the straggler for the
    startup scrub in store/journal.py)."""
    try:
        os.remove(tmp)
    except OSError:
        pass


def fsync_replace(tmp: str, path: str) -> None:
    """Atomically publish ``tmp`` at ``path``, durably: the content is
    fsynced BEFORE the rename (so the rename can never expose an empty or
    partial file after a crash) and the directory entry after."""
    if fsync_enabled():
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    os.replace(tmp, path)
    if fsync_enabled():
        fsync_dir(os.path.dirname(os.path.abspath(path)))


def durable_write(path: str, data: bytes, crc: bool = False) -> None:
    """The one home for the durable-publish pattern: pid+thread-unique
    tmp write (+ optional CRC footer), then ``fsync_replace``. Cleanup is
    ``except Exception``, deliberately NOT ``finally``: a failed attempt
    (the happy-error path) never leaks its tmp, while a crash-like
    BaseException skips the handler and leaves the straggler for the
    startup scrub — exactly like a real crash."""
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        with open(tmp, "wb") as fh:
            fh.write(data)
        if crc:
            append_crc_footer(tmp)
    except Exception:
        cleanup_tmp(tmp)
        raise
    fsync_replace(tmp, path)


def quarantine(path: str) -> str:
    """Move a corrupt file aside (``<path>.quarantine``) so the store
    keeps serving everything else; counted under ``quarantine.files`` and
    per-extension in the robustness metrics. Returns the new path — or
    the ORIGINAL path when the rename itself fails (read-only mount,
    missing permission): that is counted separately under
    ``quarantine.failed`` and never reported as quarantined, though
    callers still skip the file in-memory for this process."""
    q = path + QUARANTINE_SUFFIX
    m = robustness_metrics()
    try:
        os.replace(path, q)
    except OSError as e:
        if os.path.exists(path):  # rename failed AND the file is still there
            m.inc("quarantine.failed")
            sys.stderr.write(
                f"[integrity] FAILED to quarantine corrupt file {path}: {e}\n"
            )
            return path
        # already moved/removed by a concurrent reader: fall through
    m.inc("quarantine.files")
    ext = os.path.splitext(path)[1].lstrip(".") or "file"
    m.inc(f"quarantine.{ext}")
    sys.stderr.write(f"[integrity] quarantined corrupt file {path}\n")
    return q
