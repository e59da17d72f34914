"""Content-addressed on-disk QueueLUT store (``$REPRO_LUT_CACHE/torch``).

Port of ``repro/core/lutstore.py``.  The DES-built
:class:`~repro_torch.core.queuelut.QueueLUT` is the costliest artifact a
session rebuilds; this module persists the surfaces.  Set
``$REPRO_LUT_CACHE`` to a directory and every built surface is written
there once and read back bit-identically after -- a warm read runs ZERO
simulation (no ``memsim.simulate_cells`` call, no scan-kernel launch).

Store layout -- one ``.npz`` per surface, named by its key, in a
subdirectory of its own::

    $REPRO_LUT_CACHE/torch/qlut-<sha256[:32]>.npz

The subdirectory is what lets the port and the JAX package share one
``$REPRO_LUT_CACHE``: each package globs ``qlut-*.npz`` and ``*.corrupt``
in its own directory only, and each one's :func:`gc` drops every entry
whose fingerprint is not its own -- in one directory, each package's
``gc`` would delete the other's surfaces.

The key is a sha256 over every input that determines the tables: the
grid tuples, the DES build parameters (steps, seed, reps, engine,
harvest_bw_gbps, the base ChannelConfig's field values) and the
**mechanism fingerprint** (:func:`mechanism_fingerprint`), a hash of the
port's own simulator sources -- ``core/{memsim,threefry,xlamath,
queuelut}.py``, ``kernels/{memsim_scan,ref}.py`` and
``kernels/csrc/memsim_scan.cu`` -- plus a schema version.  Any change to
them shifts the key, so a stale surface is never read, only orphaned
(and later :func:`gc`'d).  The key leaves out the device: the card's
histograms equal the CPU's, so a surface built on either serves both.

Integrity: writes are atomic (temp file + ``os.replace`` in the store
directory), and a corrupted or truncated artifact is QUARANTINED on read
(renamed to ``*.corrupt``) and rebuilt -- never a crash.  :func:`load`
returns CPU tensors; the solver moves the tables to its own device once
per solve, so neither the store nor the bounded in-process layer on top
of it (:data:`MEM_CACHE_MAX` surfaces; :func:`clear_lut_cache` empties
it) pins device memory.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

#: Bump to invalidate every stored surface on a format change.
SCHEMA = 1

#: Environment knob naming the store's root (unset => store disabled);
#: the same variable as the JAX package's.
ENV_VAR = "REPRO_LUT_CACHE"

#: The port's subdirectory of ``$REPRO_LUT_CACHE`` (see the module note).
SUBDIR = "torch"

#: Source files whose bytes define the mechanism fingerprint, relative to
#: the package root: the simulator, its generator and math, the scan
#: kernels and their plain versions, and the table derivation.
_FINGERPRINT_SOURCES = ("core/memsim.py", "core/threefry.py",
                        "core/xlamath.py", "core/queuelut.py",
                        "kernels/memsim_scan.py", "kernels/ref.py",
                        "kernels/csrc/memsim_scan.cu")

#: Max surfaces held by the bounded in-process layer (each default
#: surface is ~100 KB of tables).
MEM_CACHE_MAX = 8

_mem_cache: OrderedDict[str, object] = OrderedDict()
_fingerprint_memo: str | None = None


def cache_dir() -> Path | None:
    """The port's store directory, ``$REPRO_LUT_CACHE/torch``, created on
    demand; unset or blank disables the on-disk store (the bounded
    in-process layer still works)."""
    path = os.environ.get(ENV_VAR, "").strip()
    if not path:
        return None
    p = Path(path) / SUBDIR
    p.mkdir(parents=True, exist_ok=True)
    return p


def mechanism_fingerprint() -> str:
    """sha256 over the simulator stack's sources + the store schema,
    memoized per process."""
    global _fingerprint_memo
    if _fingerprint_memo is None:
        h = hashlib.sha256(f"schema={SCHEMA}".encode())
        root = Path(__file__).resolve().parents[1]
        for name in _FINGERPRINT_SOURCES:
            h.update(name.encode())
            h.update((root / name).read_bytes())
        _fingerprint_memo = h.hexdigest()
    return _fingerprint_memo


def store_key(params: dict) -> str:
    """Content address of a surface: sha256 over build params + fingerprint.

    ``params`` must be JSON-serializable with deterministic ordering
    (``queuelut.resolve_lut`` canonicalizes them).
    """
    body = json.dumps({"fingerprint": mechanism_fingerprint(),
                       **params}, sort_keys=True)
    return hashlib.sha256(body.encode()).hexdigest()


def entry_path(key: str, root: Path | None = None) -> Path | None:
    root = cache_dir() if root is None else root
    if root is None:
        return None
    return root / f"qlut-{key[:32]}.npz"


def _quarantine(path: Path) -> None:
    """Move a bad artifact aside (never delete: it is evidence)."""
    try:
        path.replace(path.with_suffix(path.suffix + ".corrupt"))
    except OSError:
        pass                      # racing process already moved it


def save(key: str, lut, meta: dict | None = None) -> Path | None:
    """Persist a QueueLUT atomically; returns the path (None = disabled).
    Leaves are written as float32 numpy arrays; the round trip back
    through :func:`load` is bit-exact."""
    path = entry_path(key)
    if path is None:
        return None
    arrays = {f: leaf.detach().cpu().numpy()
              for f, leaf in zip(lut._fields, lut) if leaf is not None}
    meta = dict(meta or {}, schema=SCHEMA, key=key,
                fingerprint=mechanism_fingerprint(),
                unix_time=int(time.time()))
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, meta_json=np.frombuffer(
                json.dumps(meta).encode(), np.uint8), **arrays)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def load(key: str):
    """Read a stored surface as CPU tensors; None on miss.  Any failure to
    read, parse or validate the artifact quarantines the file and reports
    a miss, so a torn write or a flipped bit costs one rebuild."""
    path = entry_path(key)
    if path is None or not path.exists():
        return None
    from repro_torch.core.queuelut import QueueLUT  # queuelut imports us
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z["meta_json"]).decode())
            if meta.get("schema") != SCHEMA or meta.get("key") != key:
                raise ValueError("schema/key mismatch")
            if meta.get("fingerprint") != mechanism_fingerprint():
                raise ValueError("fingerprint mismatch")
            fields = {f: torch.from_numpy(np.array(z[f]))
                      for f in QueueLUT._fields if f in z.files}
        for f in QueueLUT._fields[:8]:        # grids + the four tables
            if f not in fields:
                raise ValueError(f"missing field {f}")
        return QueueLUT(**fields)
    except Exception:             # noqa: BLE001 -- ANY read failure
        _quarantine(path)
        return None


def read_meta(path: Path) -> dict | None:
    """Best-effort meta block of one store entry (None if unreadable)."""
    try:
        with np.load(path, allow_pickle=False) as z:
            return json.loads(bytes(z["meta_json"]).decode())
    except Exception:             # noqa: BLE001 -- inspect never raises
        return None


def entries() -> list[dict]:
    """Every store entry with its meta (for ``python -m repro_torch.lut``)."""
    root = cache_dir()
    if root is None:
        return []
    out = []
    for path in sorted(root.glob("qlut-*.npz")):
        meta = read_meta(path) or {}
        out.append(dict(path=str(path), bytes=path.stat().st_size,
                        **meta))
    return out


def gc(max_age_days: float | None = None, everything: bool = False) -> dict:
    """Drop stale entries (and all ``*.corrupt`` quarantine files) of the
    port's store directory.

    ``everything=True`` empties it; otherwise entries older than
    ``max_age_days`` (by recorded build time, falling back to mtime) and
    entries whose fingerprint no longer matches the current simulator
    are removed.  Returns ``{"removed": n, "bytes": freed}``.
    """
    root = cache_dir()
    if root is None:
        return dict(removed=0, bytes=0)
    removed = freed = 0
    now = time.time()
    fp = mechanism_fingerprint()
    for path in list(root.glob("qlut-*.npz")) + \
            list(root.glob("*.corrupt")):
        drop = everything or path.suffix == ".corrupt"
        if not drop:
            meta = read_meta(path)
            if meta is None or meta.get("fingerprint") != fp:
                drop = True
            elif max_age_days is not None:
                built = meta.get("unix_time", path.stat().st_mtime)
                drop = (now - built) > max_age_days * 86_400.0
        if drop:
            try:
                size = path.stat().st_size
                path.unlink()
                removed += 1
                freed += size
            except OSError:
                pass
    return dict(removed=removed, bytes=freed)


# ---------------------------------------------------------------------------
# Bounded in-process layer.
# ---------------------------------------------------------------------------

def cache_get(key: str):
    """In-process LRU lookup (refreshes recency on hit)."""
    lut = _mem_cache.get(key)
    if lut is not None:
        _mem_cache.move_to_end(key)
    return lut


def cache_put(key: str, lut) -> None:
    _mem_cache[key] = lut
    _mem_cache.move_to_end(key)
    while len(_mem_cache) > MEM_CACHE_MAX:
        _mem_cache.popitem(last=False)


def clear_lut_cache() -> None:
    """Empty the bounded in-process layer (the on-disk store is
    untouched)."""
    _mem_cache.clear()
