"""Persistent key-value store: ctypes binding over the native C++ log store,
the port's copy of owshen_tpu/runtime/store.py (same API, same file format).

The role LevelDB plays in the Owshen node (src/db/disk.rs:26-63
`DiskKvStore`, trait `KvStore` src/db/mod.rs:24-52): a durable byte KV store
with atomic batch commit.  The native engine (owshen_tpu_torch/native/
store.cc) is an append-only log with CRC-framed records and commit markers —
a trailing uncommitted batch is discarded on open, mirroring the Writebatch
atomicity `Owshenchain::atomic` relies on (src/blockchain/mod.rs:90-99).

The .so is built from the port's source with g++ on first use, into the
git-ignored kernels/_build/; when no g++ is present, a pure-Python engine
with the same contract (atomic via temp-file rename) serves instead.  This
concerns the host store only: no kernel and no device is involved.
"""

from __future__ import annotations

import ctypes
import os
import pickle
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "native", "store.cc")
_SO = os.path.join(_PKG, "kernels", "_build", "_libowshen_store.so")
_build_lock = threading.Lock()
_lib = None
_lib_failed = False


def _load_lib():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _build_lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                os.makedirs(os.path.dirname(_SO), exist_ok=True)
                tmp = f"{_SO}.{os.getpid()}.tmp"     # concurrent builders never share a file
                subprocess.run(
                    ["g++", "-O2", "-fPIC", "-shared", "-std=c++17",
                     _SRC, "-o", tmp],
                    check=True, capture_output=True)
                os.replace(tmp, _SO)
            lib = ctypes.CDLL(_SO)
            lib.owshen_store_open.restype = ctypes.c_void_p
            lib.owshen_store_open.argtypes = [ctypes.c_char_p]
            lib.owshen_store_put.restype = ctypes.c_int
            lib.owshen_store_put.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
                ctypes.c_char_p, ctypes.c_uint32]
            lib.owshen_store_delete.restype = ctypes.c_int
            lib.owshen_store_delete.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
            lib.owshen_store_commit.restype = ctypes.c_int
            lib.owshen_store_commit.argtypes = [ctypes.c_void_p]
            lib.owshen_store_get.restype = ctypes.c_int64
            lib.owshen_store_get.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
                ctypes.c_void_p, ctypes.c_uint64]
            lib.owshen_store_count.restype = ctypes.c_uint64
            lib.owshen_store_count.argtypes = [ctypes.c_void_p]
            lib.owshen_store_key_at.restype = ctypes.c_int64
            lib.owshen_store_key_at.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p,
                ctypes.c_uint64]
            lib.owshen_store_compact.restype = ctypes.c_int
            lib.owshen_store_compact.argtypes = [ctypes.c_void_p]
            lib.owshen_store_close.restype = None
            lib.owshen_store_close.argtypes = [ctypes.c_void_p]
            _lib = lib
        except Exception:  # noqa: BLE001 — toolchain missing: fall back
            _lib_failed = True
    return _lib


# The native log's replay guard treats any record with klen/vlen > 2^30 as
# a torn tail and truncates there (store.cc) — so accepting such a put
# would commit a batch the next open silently DISCARDS (a 1.27 GB
# prover-table pickle once made a whole pool checkpoint vanish).  Both
# engines reject oversized records loudly; large blobs must be chunked
# (runtime/checkpoint._put_blob does).
MAX_RECORD = 1 << 30


def _check_record_size(key: bytes, value: bytes):
    if len(key) >= MAX_RECORD or len(value) >= MAX_RECORD:
        raise ValueError(
            f"record too large for the log format ({len(value)} bytes >= "
            f"{MAX_RECORD}); chunk large blobs across keys")


class NativeKvStore:
    """Durable KV store over the native log engine (atomic batch commit)."""

    def __init__(self, path: str):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native store unavailable (no g++?)")
        self._lib = lib
        self._h = lib.owshen_store_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open store at {path}")
        self.path = path

    def put(self, key: bytes, value: bytes):
        if not key:
            # an empty-key record would be framed identically to the log's
            # COMMIT marker, and replay would truncate later batches
            raise ValueError("empty keys are not supported")
        _check_record_size(key, value)
        if self._lib.owshen_store_put(self._h, key, len(key),
                                      value, len(value)) != 0:
            raise IOError("put failed")

    def delete(self, key: bytes):
        if not key:
            raise ValueError("empty keys are not supported")
        if self._lib.owshen_store_delete(self._h, key, len(key)) != 0:
            raise IOError("delete failed")

    def commit(self):
        """Durably commit everything put since the last commit (fsync'd).
        Uncommitted puts are DISCARDED on reopen — this is the atomic-batch
        contract (reference Writebatch, disk.rs:50-63)."""
        if self._lib.owshen_store_commit(self._h) != 0:
            raise IOError("commit failed")

    def get(self, key: bytes) -> bytes | None:
        n = self._lib.owshen_store_get(self._h, key, len(key), None, 0)
        if n < 0:
            return None
        buf = ctypes.create_string_buffer(int(n))
        got = self._lib.owshen_store_get(self._h, key, len(key), buf, n)
        if got != n:
            raise IOError("get failed")
        return buf.raw

    def keys(self) -> list[bytes]:
        out = []
        cnt = self._lib.owshen_store_count(self._h)
        for i in range(cnt):
            n = self._lib.owshen_store_key_at(self._h, i, None, 0)
            buf = ctypes.create_string_buffer(int(n))
            self._lib.owshen_store_key_at(self._h, i, buf, n)
            out.append(buf.raw)
        return out

    def __len__(self):
        return int(self._lib.owshen_store_count(self._h))

    def compact(self):
        """Rewrite the live set into a fresh log.  Refuses while a batch is
        pending (commit or close-discard first) — compacting would otherwise
        silently commit writes the caller never committed."""
        if self._lib.owshen_store_compact(self._h) != 0:
            raise IOError("compact failed (pending uncommitted batch?)")

    def close(self):
        """Close, DISCARDING any uncommitted puts/deletes (the Writebatch
        contract: only commit() makes a batch durable).  Same semantics as
        PyKvStore.close, so checkpoint code behaves identically whether or
        not g++ is available."""
        if self._h:
            self._lib.owshen_store_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PyKvStore:
    """Pure-Python fallback with the same API.  Atomicity via write-temp +
    rename (the whole map is pickled per commit — fine for checkpoint-sized
    state, not a production store)."""

    def __init__(self, path: str):
        self.path = path
        self._data: dict[bytes, bytes] = {}
        self._pending: dict[bytes, bytes | None] = {}
        if os.path.exists(path):
            with open(path, "rb") as fh:
                head = fh.read(2)
                if head:
                    fh.seek(0)
                    self._data = pickle.load(fh)

    def put(self, key: bytes, value: bytes):
        if not key:
            raise ValueError("empty keys are not supported")
        _check_record_size(key, value)  # same contract as the native engine
        self._pending[key] = value

    def delete(self, key: bytes):
        if not key:
            raise ValueError("empty keys are not supported")
        self._pending[key] = None

    def commit(self):
        for k, v in self._pending.items():
            if v is None:
                self._data.pop(k, None)
            else:
                self._data[k] = v
        self._pending.clear()
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as fh:
            pickle.dump(self._data, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.path)

    def get(self, key: bytes) -> bytes | None:
        if key in self._pending:
            return self._pending[key]
        return self._data.get(key)

    def keys(self) -> list[bytes]:
        live = dict(self._data)
        for k, v in self._pending.items():
            if v is None:
                live.pop(k, None)
            else:
                live[k] = v
        return sorted(live)

    def __len__(self):
        return len(self.keys())

    def compact(self):
        """No log to rewrite; refuse while a batch is pending (same
        contract as the native engine)."""
        if self._pending:
            raise IOError("compact failed (pending uncommitted batch?)")

    def close(self):
        """Uncommitted puts are discarded (the Writebatch contract)."""
        self._pending.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_store(path: str):
    """Open the native store, falling back to the Python engine if the
    native build is unavailable."""
    if _load_lib() is not None:
        return NativeKvStore(path)
    return PyKvStore(path)
