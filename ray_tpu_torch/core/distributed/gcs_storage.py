"""Durable GCS state: snapshot + write-ahead log on local disk.

The port's copy of `ray_tpu/core/distributed/gcs_storage.py`,
importing `ray_tpu_torch` only.

Analogue of the reference's pluggable GCS storage
(ref: src/ray/gcs/store_client/ — InMemoryStoreClient vs
RedisStoreClient, selected by the `gcs_storage` knob,
ray_config_def.h:402; with Redis the GCS survives restarts and raylets
reconnect within gcs_rpc_server_reconnect_timeout_s :439). This build's
durable backend is a file pair per storage dir:

    snapshot.pkl   full {table: {key: value}} image
    wal.pkl        length-prefixed pickled (op, table, key, value)
                   records appended after the snapshot

Writes append to the WAL synchronously (one small write + flush +
fsync — flush alone only reaches the OS page cache, which a host/power
failure loses; RAY_TPU_GCS_FSYNC=0 downgrades to process-restart-only
durability when write latency matters more). A snapshot rewrite folds
the WAL in whenever it grows past `snapshot_every` records. Load =
snapshot + WAL replay.
"""
from __future__ import annotations

import os
import pickle
import struct
import threading
from typing import Any, Dict, Optional

_LEN = struct.Struct("<I")


class PersistentStore:
    def __init__(self, directory: str, snapshot_every: int = 5000):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._snapshot_path = os.path.join(directory, "snapshot.pkl")
        self._wal_path = os.path.join(directory, "wal.pkl")
        self._snapshot_every = snapshot_every
        from ray_tpu_torch.core.config import get_config

        self._fsync = bool(get_config().gcs_fsync)
        self._lock = threading.Lock()
        self._tables: Dict[str, Dict[Any, Any]] = {}
        self._wal_count = 0
        good_bytes = self._load()
        # Truncate any torn/corrupt tail BEFORE appending: records
        # written after unreadable bytes would be unreachable on the
        # next replay (silent data loss on the second restart).
        if os.path.exists(self._wal_path) and \
                os.path.getsize(self._wal_path) > good_bytes:
            with open(self._wal_path, "r+b") as f:
                f.truncate(good_bytes)
        self._wal = open(self._wal_path, "ab")

    # -- recovery -------------------------------------------------------
    def _load(self) -> int:
        """Replay snapshot + WAL; returns the byte offset of the last
        fully-valid WAL record (the truncation point for torn tails)."""
        if os.path.exists(self._snapshot_path):
            with open(self._snapshot_path, "rb") as f:
                self._tables = pickle.load(f)
        good_bytes = 0
        if os.path.exists(self._wal_path):
            with open(self._wal_path, "rb") as f:
                while True:
                    head = f.read(_LEN.size)
                    if len(head) < _LEN.size:
                        break
                    (n,) = _LEN.unpack(head)
                    blob = f.read(n)
                    if len(blob) < n:
                        break  # torn tail write
                    try:
                        op, table, key, value = pickle.loads(blob)
                    except Exception:  # noqa: BLE001 corrupt tail
                        break
                    if op == "put":
                        self._tables.setdefault(table, {})[key] = value
                    else:
                        self._tables.get(table, {}).pop(key, None)
                    self._wal_count += 1
                    good_bytes = f.tell()
        return good_bytes

    # -- write path -----------------------------------------------------
    def _append(self, op: str, table: str, key: Any, value: Any) -> None:
        blob = pickle.dumps((op, table, key, value), protocol=5)
        with self._lock:
            self._wal.write(_LEN.pack(len(blob)) + blob)
            self._wal.flush()
            if self._fsync:
                os.fsync(self._wal.fileno())
            self._wal_count += 1
            if self._wal_count >= self._snapshot_every:
                self._compact_locked()

    def _compact_locked(self) -> None:
        tmp = self._snapshot_path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(self._tables, f, protocol=5)
            if self._fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, self._snapshot_path)
        self._wal.close()
        self._wal = open(self._wal_path, "wb")
        self._wal_count = 0

    def put(self, table: str, key: Any, value: Any) -> None:
        self._tables.setdefault(table, {})[key] = value
        self._append("put", table, key, value)

    def delete(self, table: str, key: Any) -> None:
        if self._tables.get(table, {}).pop(key, None) is not None:
            self._append("del", table, key, None)

    def all(self, table: str) -> Dict[Any, Any]:
        return dict(self._tables.get(table, {}))

    def close(self) -> None:
        with self._lock:
            try:
                self._wal.close()
            except Exception:  # noqa: BLE001
                pass


class NullStore:
    """In-memory default (the reference's gcs_storage="memory")."""

    def put(self, table: str, key: Any, value: Any) -> None:
        pass

    def delete(self, table: str, key: Any) -> None:
        pass

    def all(self, table: str) -> Dict[Any, Any]:
        return {}

    def close(self) -> None:
        pass


def open_store(directory: Optional[str]):
    return PersistentStore(directory) if directory else NullStore()
