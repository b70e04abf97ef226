"""Distributed KV / service-discovery store with interchangeable backends.

The port's copy of ``areal_tpu/base/name_resolve.py``: workers use it for
rendezvous, liveness (keepalive TTL), and small control state (model version,
weight-stream endpoints, server URLs).

 - ``MemoryNameRecordRepo`` — in-process dict (single-process tests/local).
 - ``NfsNameRecordRepo`` — files under a shared directory (multi-process on
   one host or over NFS; the default). Its on-disk format and default root
   are the reference's, so both packages read and write one directory.

No etcd3 repository exists in either package: ``reconfigure`` rejects
``type="etcd3"``. Keys are slash-separated; values are short strings.
Logging goes through the standard library's ``logging``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil
import tempfile
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional

logger = logging.getLogger("areal_tpu_torch.name_resolve")


class NameEntryExistsError(Exception):
    pass


class NameEntryNotFoundError(Exception):
    pass


class NameRecordRepository:
    def add(
        self,
        name: str,
        value: str,
        delete_on_exit: bool = True,
        keepalive_ttl: Optional[float] = None,
        replace: bool = False,
    ) -> None:
        raise NotImplementedError()

    def add_subentry(self, name: str, value: str, **kwargs) -> str:
        sub = str(uuid.uuid4())[:8]
        self.add(f"{name}/{sub}", value, **kwargs)
        return f"{name}/{sub}"

    def get(self, name: str) -> str:
        raise NotImplementedError()

    def touch(self, name: str) -> None:
        """Refresh a key's keepalive lease (no-op for keys registered
        without ``keepalive_ttl``). Raises NameEntryNotFoundError when the
        key is absent or its lease already expired — the caller's
        registration is gone and must be re-added, not refreshed."""
        raise NotImplementedError()

    def delete(self, name: str) -> None:
        raise NotImplementedError()

    def clear_subtree(self, root: str) -> None:
        raise NotImplementedError()

    def get_subtree(self, root: str) -> List[str]:
        """Values of all keys under root."""
        raise NotImplementedError()

    def find_subtree(self, root: str) -> List[str]:
        """Keys under root, sorted."""
        raise NotImplementedError()

    def wait(
        self, name: str, timeout: Optional[float] = None, poll_frequency: float = 0.1
    ) -> str:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                return self.get(name)
            except NameEntryNotFoundError:
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"timed out waiting for key: {name}")
                time.sleep(poll_frequency)

    def watch_names(
        self,
        names: List[str],
        call_back: Callable[[], None],
        poll_frequency: float = 5.0,
    ) -> threading.Thread:
        """Fire call_back once when any of the names disappears."""

        def _watch():
            while True:
                for n in names:
                    try:
                        self.get(n)
                    except NameEntryNotFoundError:
                        call_back()
                        return
                time.sleep(poll_frequency)

        t = threading.Thread(target=_watch, daemon=True)
        t.start()
        return t

    def reset(self) -> None:
        pass


class MemoryNameRecordRepo(NameRecordRepository):
    def __init__(self):
        # name -> (value, expiry_monotonic_or_None, ttl_or_None)
        self._store: Dict[str, tuple] = {}
        self._lock = threading.Lock()

    def add(self, name, value, delete_on_exit=True, keepalive_ttl=None, replace=False):
        name = name.rstrip("/")
        with self._lock:
            self._purge_expired_locked(name)
            if name in self._store and not replace:
                raise NameEntryExistsError(name)
            expiry = (
                time.monotonic() + keepalive_ttl if keepalive_ttl else None
            )
            self._store[name] = (str(value), expiry, keepalive_ttl)

    def _purge_expired_locked(self, name) -> bool:
        """True iff the key existed but its lease had expired (purged)."""
        rec = self._store.get(name)
        if rec is None:
            return False
        if rec[1] is not None and time.monotonic() > rec[1]:
            del self._store[name]
            return True
        return False

    def get(self, name):
        name = name.rstrip("/")
        with self._lock:
            if self._purge_expired_locked(name) or name not in self._store:
                raise NameEntryNotFoundError(name)
            return self._store[name][0]

    def touch(self, name):
        name = name.rstrip("/")
        with self._lock:
            if self._purge_expired_locked(name) or name not in self._store:
                raise NameEntryNotFoundError(name)
            value, _, ttl = self._store[name]
            if ttl:
                self._store[name] = (value, time.monotonic() + ttl, ttl)

    def delete(self, name):
        with self._lock:
            if name not in self._store:
                raise NameEntryNotFoundError(name)
            del self._store[name]

    @staticmethod
    def _under(key: str, root: str) -> bool:
        root = root.rstrip("/")
        return key == root or key.startswith(root + "/")

    def clear_subtree(self, root):
        with self._lock:
            for k in [k for k in self._store if self._under(k, root)]:
                del self._store[k]

    def get_subtree(self, root):
        with self._lock:
            return [
                self._store[k][0] for k in sorted(self._store)
                if self._under(k, root)
                and not self._purge_expired_locked(k)
            ]

    def find_subtree(self, root):
        with self._lock:
            return sorted(
                k for k in list(self._store)
                if self._under(k, root)
                and not self._purge_expired_locked(k)
            )

    def reset(self):
        with self._lock:
            self._store.clear()


class NfsNameRecordRepo(NameRecordRepository):
    """One file per key under a shared root directory."""

    def __init__(self, record_root: Optional[str] = None):
        # Normalized, so that pruning empty directories stops at the root
        # whatever trailing slash it was given with.
        self._root = os.path.abspath(record_root or os.environ.get(
            "AREAL_NAME_RESOLVE_ROOT",
            os.path.join(tempfile.gettempdir(), "areal_tpu", "name_resolve"),
        ))
        self._to_delete: List[str] = []

    def _path(self, name: str) -> str:
        name = name.strip("/")
        return os.path.join(self._root, name, "ENTRY")

    @staticmethod
    def _ttl_path(entry_path: str) -> str:
        # Keepalive sidecar: the lease TTL in seconds; the ENTRY file's
        # mtime is the heartbeat timestamp (touch() refreshes it).
        return os.path.join(os.path.dirname(entry_path), "TTL")

    def _lease_expired(self, path: str) -> bool:
        ttl_path = self._ttl_path(path)
        try:
            with open(ttl_path) as f:
                ttl = float(f.read().strip())
            age = time.time() - os.path.getmtime(path)
        except (OSError, ValueError):
            return False  # no lease on this key (or racing deletion)
        return ttl > 0 and age > ttl

    def _purge_expired(self, name: str) -> None:
        logger.warning(f"name_resolve lease expired: {name}")
        try:
            self.delete(name)
        except (NameEntryNotFoundError, OSError):
            pass  # another observer purged it first

    def add(self, name, value, delete_on_exit=True, keepalive_ttl=None, replace=False):
        path = self._path(name)
        if os.path.exists(path) and not (replace or self._lease_expired(path)):
            raise NameEntryExistsError(name)
        # Unique per writer: two threads of one process may add one key.
        tmp = path + f".tmp{os.getpid()}.{threading.get_ident()}"
        for attempt in range(64):
            try:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(tmp, "w") as f:
                    f.write(str(value))
                break
            except (FileNotFoundError, FileExistsError):
                # A concurrent delete pruned a directory as it was made.
                if attempt == 63:
                    raise
        # ENTRY first, TTL sidecar second. The other order opens a purge
        # race: a concurrent reader sees the NEW ttl against the STALE
        # entry's old mtime, judges the lease expired, and deletes the
        # just-written sidecar — leaving the re-registration permanently
        # lease-less (its ghost would never expire after a later kill).
        # This order's transient states are safe: fresh ENTRY + old TTL
        # is unexpired (fresh mtime), and ENTRY with no TTL yet is just
        # momentarily lease-less.
        os.replace(tmp, path)
        ttl_path = self._ttl_path(path)
        if keepalive_ttl:
            ttl_tmp = ttl_path + f".tmp{os.getpid()}.{threading.get_ident()}"
            with open(ttl_tmp, "w") as f:
                f.write(repr(float(keepalive_ttl)))
            os.replace(ttl_tmp, ttl_path)
        elif os.path.exists(ttl_path):
            # Re-registration WITHOUT a lease must not inherit the dead
            # predecessor's TTL and expire out from under the new owner.
            try:
                os.remove(ttl_path)
            except OSError:
                pass
        if delete_on_exit:
            self._to_delete.append(name)

    def get(self, name):
        path = self._path(name)
        try:
            if self._lease_expired(path):
                self._purge_expired(name)
                raise NameEntryNotFoundError(name)
            with open(path) as f:
                return f.read()
        except FileNotFoundError:
            raise NameEntryNotFoundError(name) from None

    def touch(self, name):
        path = self._path(name)
        if not os.path.exists(path) or self._lease_expired(path):
            raise NameEntryNotFoundError(name)
        os.utime(path, None)

    def delete(self, name):
        path = self._path(name)
        try:
            os.remove(path)
        except FileNotFoundError:
            # Absent, or another process's delete won the race.
            raise NameEntryNotFoundError(name) from None
        try:
            os.remove(self._ttl_path(path))
        except OSError:
            pass
        # Prune empty dirs up to root. A concurrent delete may have pruned
        # one already, and a concurrent add may have just refilled one:
        # either ends the pruning, never the delete.
        d = os.path.dirname(path)
        while d != self._root:
            try:
                os.rmdir(d)
            except OSError:
                break
            d = os.path.dirname(d)

    def clear_subtree(self, root):
        d = os.path.join(self._root, root.strip("/"))
        if os.path.isdir(d):
            shutil.rmtree(d, ignore_errors=True)

    def find_subtree(self, root):
        base = os.path.join(self._root, root.strip("/"))
        out = []
        for dirpath, _dirnames, filenames in os.walk(base):
            if "ENTRY" in filenames:
                rel = os.path.relpath(dirpath, self._root)
                key = rel.replace(os.sep, "/")
                path = os.path.join(dirpath, "ENTRY")
                if self._lease_expired(path):
                    self._purge_expired(key)
                    continue
                out.append(key)
        return sorted(out)

    def get_subtree(self, root):
        out = []
        for k in self.find_subtree(root):
            try:
                out.append(self.get(k))
            except NameEntryNotFoundError:
                pass  # purged between the walk and the read
        return out

    def reset(self):
        for name in self._to_delete:
            try:
                self.delete(name)
            except NameEntryNotFoundError:
                pass
        self._to_delete.clear()


@dataclasses.dataclass
class NameResolveConfig:
    """The reference's NameResolveConfig, field for field."""

    type: str = "nfs"  # memory | nfs ("etcd3" is rejected)
    nfs_record_root: Optional[str] = None


DEFAULT_REPO: NameRecordRepository = NfsNameRecordRepo()


def reconfigure(config: NameResolveConfig) -> None:
    global DEFAULT_REPO
    if config.type == "memory":
        DEFAULT_REPO = MemoryNameRecordRepo()
    elif config.type == "nfs":
        DEFAULT_REPO = NfsNameRecordRepo(config.nfs_record_root)
    elif config.type == "etcd3":
        raise NotImplementedError(
            "name_resolve type='etcd3' has no repository — use type='nfs' "
            "(multi-host) or type='memory' (single-process)"
        )
    else:
        raise ValueError(f"unknown name_resolve type {config.type}")


def add(name, value, **kwargs):
    return DEFAULT_REPO.add(name, value, **kwargs)


def add_subentry(name, value, **kwargs):
    return DEFAULT_REPO.add_subentry(name, value, **kwargs)


def get(name):
    return DEFAULT_REPO.get(name)


def touch(name):
    return DEFAULT_REPO.touch(name)


def delete(name):
    return DEFAULT_REPO.delete(name)


def clear_subtree(root):
    return DEFAULT_REPO.clear_subtree(root)


def get_subtree(root):
    return DEFAULT_REPO.get_subtree(root)


def find_subtree(root):
    return DEFAULT_REPO.find_subtree(root)


def wait(name, timeout=None, poll_frequency=0.1):
    return DEFAULT_REPO.wait(name, timeout, poll_frequency)


def watch_names(names, call_back, poll_frequency=5.0):
    return DEFAULT_REPO.watch_names(names, call_back, poll_frequency)


def reset():
    return DEFAULT_REPO.reset()
