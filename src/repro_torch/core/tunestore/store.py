"""The on-disk tuning store (DESIGN.md §13): schema-versioned, atomically
written JSON holding everything a warm process needs to reach tuned
steady state without one measurement launch: each family's
``BucketCostModel`` tables (the ``s3`` buckets, the ``s2`` coalesce
widths, the whole-wave ``fused`` launch), its derived bucket ladder, its
``inner_chunk``, its ``selected_strategy`` / ``strategy_costs`` and the
observed queue histogram the flush policies key on.

Keying (staleness is a key mismatch, never a guess):

* the file is valid for ONE ``(schema, code salt)`` pair; the salt hashes
  this package's ``core/aggregation.py`` and this module, so a store
  written by other code, the JAX reference package included, is ignored
  whole (its measurements may describe launches that no longer exist);
* each entry is keyed ``backend|device name|d<count>|TaskSignature
  .describe()``, the executor's ``_backend_key()`` and the family, so a
  table timed on one device or device count never warm-starts another;
* the payload carries a content hash: a truncated or hand-edited file
  fails closed (a :class:`TuneStoreWarning` and a cold start, never a
  crash and never a wrong ladder).

Writes go through a temp file in the same directory and ``os.replace``, so
a concurrent reader sees the old store or the new one, never a torn file.

The reference's store also points JAX's persistent compilation cache at
the store directory, so process two recompiles nothing.  The port has no
compiler to point there: its kernels are nvcc-built libraries, and
``repro_torch.kernels._build`` already builds each one once into
``src/repro_torch/_build/<digest>/``, which persists across processes (a
cache hit loads the library and leaves ``BUILD_LOG[name]["seconds"]``
None).  That build cache plays the compilation half's role.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import warnings
from typing import Any, Dict, Optional, Tuple

SCHEMA_VERSION = 1
STORE_FILENAME = "tunestore.json"

# consulted when no explicit ``tune_store`` is configured: point every
# process of a deployment at one directory (README, "Warm start")
STORE_ENV_VAR = "REPRO_TUNE_STORE"

_SALT_SOURCES = ("aggregation.py",)   # relative to repro_torch/core
_code_salt_memo: Optional[str] = None


def code_salt() -> str:
    """Hash of the tuning-relevant sources (the aggregation runtime and
    this module): a store written by other code is stale by definition."""
    global _code_salt_memo
    if _code_salt_memo is None:
        h = hashlib.blake2b(digest_size=8)
        core = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        for path in [os.path.join(core, s) for s in _SALT_SOURCES] + [
                os.path.abspath(__file__)]:
            try:
                with open(path, "rb") as f:
                    h.update(f.read())
            except OSError:
                h.update(path.encode())
        _code_salt_memo = h.hexdigest()
    return _code_salt_memo


def entry_key(backend_key: Tuple[str, ...], family: str) -> str:
    """``backend|device name|d<count>|TaskSignature.describe()``: the
    identity a stored entry is valid for.  Every part of the backend key
    is joined, so the device count partitions the store."""
    return "|".join((*backend_key, family))


def _content_hash(entries: Dict[str, Any]) -> str:
    blob = json.dumps(entries, sort_keys=True,
                      separators=(",", ":")).encode()
    return hashlib.blake2b(blob, digest_size=16).hexdigest()


class TuneStoreWarning(UserWarning):
    """A store file was unusable (corrupt, stale schema or salt, bad
    hash); the process falls back to cold-start measurement."""


class TuneStore:
    """One warm-start store rooted at a directory.

    Loading is fail-closed: any structural problem (unparsable JSON, a
    non-object top level, schema or salt mismatch, a malformed entry
    table, a content-hash mismatch) leaves an empty entry table and a
    :class:`TuneStoreWarning`.  ``save()`` is atomic and merges this
    process's entries over the valid ones on disk, so processes tuning
    different families keep each other's entries.
    """

    def __init__(self, root: str):
        self.root = os.path.abspath(str(root))
        self.path = os.path.join(self.root, STORE_FILENAME)
        self._entries: Dict[str, Dict[str, Any]] = {}
        self._loaded = False

    @classmethod
    def open(cls, spec: Any) -> Optional["TuneStore"]:
        """A config knob as a store: a :class:`TuneStore` passes through,
        a path opens one, and ``None`` reads ``REPRO_TUNE_STORE`` (unset:
        no store, the cold start)."""
        if spec is None:
            spec = os.environ.get(STORE_ENV_VAR) or None
            if spec is None:
                return None
        if isinstance(spec, TuneStore):
            return spec
        return cls(str(spec))

    # -- persistence -------------------------------------------------------
    def _ensure_loaded(self) -> None:
        if not self._loaded:
            self._entries = self._read_file()
            self._loaded = True

    def _read_file(self) -> Dict[str, Dict[str, Any]]:
        try:
            with open(self.path) as f:
                payload = json.load(f)
        except FileNotFoundError:
            return {}
        except (OSError, json.JSONDecodeError, UnicodeDecodeError) as err:
            warnings.warn(
                f"tune store {self.path} is unreadable ({err}) — "
                f"falling back to cold-start measurement",
                TuneStoreWarning, stacklevel=3)
            return {}
        if not isinstance(payload, dict):
            warnings.warn(
                f"tune store {self.path} has a non-object top level — "
                f"ignoring it", TuneStoreWarning, stacklevel=3)
            return {}
        if payload.get("schema") != SCHEMA_VERSION:
            warnings.warn(
                f"tune store {self.path} has schema "
                f"{payload.get('schema')!r} (this code reads "
                f"{SCHEMA_VERSION}) — ignoring it",
                TuneStoreWarning, stacklevel=3)
            return {}
        if payload.get("salt") != code_salt():
            warnings.warn(
                f"tune store {self.path} was written by other code (salt "
                f"{payload.get('salt')!r} != {code_salt()!r}) — its "
                f"measurements may describe launches that no longer exist; "
                f"ignoring it", TuneStoreWarning, stacklevel=3)
            return {}
        entries = payload.get("entries")
        if not isinstance(entries, dict) or not all(
                isinstance(v, dict) for v in entries.values()):
            warnings.warn(
                f"tune store {self.path} has a malformed entry table — "
                f"ignoring it", TuneStoreWarning, stacklevel=3)
            return {}
        if payload.get("hash") != _content_hash(entries):
            warnings.warn(
                f"tune store {self.path} fails its content hash "
                f"(truncated or hand-edited write) — ignoring it",
                TuneStoreWarning, stacklevel=3)
            return {}
        return entries

    def save(self) -> None:
        """Merge this process's entries over the valid entries on disk and
        write them atomically (temp file, then ``os.replace``).  A save
        that changes nothing in a valid file writes nothing (checkpoints
        save on their cadence); a corrupt file is repaired."""
        os.makedirs(self.root, exist_ok=True)
        self._ensure_loaded()
        with warnings.catch_warnings():
            # a corrupt file on disk must not block the repairing write
            warnings.simplefilter("ignore", TuneStoreWarning)
            on_disk = self._read_file()
        merged = dict(on_disk)
        merged.update(self._entries)
        self._entries = merged
        if on_disk == merged and os.path.exists(self.path):
            return
        payload = {"schema": SCHEMA_VERSION, "salt": code_salt(),
                   "entries": merged, "hash": _content_hash(merged)}
        fd, tmp = tempfile.mkstemp(dir=self.root, prefix=".tunestore-",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- entries -----------------------------------------------------------
    def get(self, backend_key: Tuple[str, ...],
            family: str) -> Optional[Dict[str, Any]]:
        """The entry for one backend key and family, or None (entries of
        other devices are other keys)."""
        self._ensure_loaded()
        return self._entries.get(entry_key(backend_key, family))

    def put(self, backend_key: Tuple[str, ...], family: str,
            entry: Dict[str, Any]) -> None:
        self._ensure_loaded()
        self._entries[entry_key(backend_key, family)] = entry

    def entries(self) -> Dict[str, Dict[str, Any]]:
        self._ensure_loaded()
        return dict(self._entries)

    def __len__(self) -> int:
        self._ensure_loaded()
        return len(self._entries)
