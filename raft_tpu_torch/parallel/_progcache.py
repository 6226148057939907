"""Releasable memoization for the distributed drivers.

Counterpart of raft_tpu/parallel/_progcache.py, copied. The JAX drivers
memoize one jitted shard_map program per static config; eager PyTorch has
no program to keep, so the port's drivers memoize what they would
otherwise redo on every call: the calling rank's padded slice of an index
on its device (:func:`memo`). The entries key on the live
:class:`~raft_tpu_torch.comms.Comms` and hold it (and through it the mesh
and its process groups) and the device slices strongly, so a retired
communicator must be released: :func:`raft_tpu_torch.parallel.release_programs`
drops every entry keyed on it. An entry also goes when the index it was
sliced from is garbage, and is built again when a field of the index was
replaced or one of its tensors written in place since, so a caller's
changed index never finds an old slice.

Same bounded-LRU semantics and hit behaviour as the JAX class (same key →
the SAME object), plus :meth:`ProgramCache.release` — drop every entry keyed
on one comms — :meth:`ProgramCache.clear` and :meth:`ProgramCache.discard`.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import weakref
from typing import Callable

import torch

__all__ = ["ProgramCache", "memo"]


class ProgramCache:
    """Thread-safe bounded LRU keyed on ``(comms, *static_config)``.

    The first key element must be the communicator — that is what
    :meth:`release` matches on. ``build`` runs UNDER the cache lock (it
    slices and places tensors and runs no collective), and an insert that
    raced a concurrent :meth:`release` of the same communicator would
    otherwise re-pin the mesh the release just claimed to free."""

    def __init__(self, maxsize: int = 256):
        self.maxsize = int(maxsize)
        self._d: collections.OrderedDict = collections.OrderedDict()
        # re-entrant: dropping an entry can free the object another entry's
        # weak reference watches, whose callback discards under the lock
        self._lock = threading.RLock()

    def discard(self, key: tuple) -> None:
        """Drop one entry, if present."""
        with self._lock:
            self._d.pop(key, None)

    def get_or_build(self, key: tuple, build: Callable, fresh: Callable | None = None):
        """The entry under ``key``, built (or built again, where ``fresh``
        of the entry is false) under the lock."""
        with self._lock:
            fn = self._d.get(key)
            if fn is None or (fresh is not None and not fresh(fn)):
                fn = self._d[key] = build()
                while len(self._d) > self.maxsize:
                    self._d.popitem(last=False)
            else:
                self._d.move_to_end(key)
            return fn

    def release(self, comms) -> int:
        """Evict every program whose key's communicator == ``comms``;
        returns how many were dropped."""
        with self._lock:
            dead = [k for k in self._d if k[0] == comms]
            for k in dead:
                del self._d[k]
        return len(dead)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def keys_for(self, comms) -> list:
        """The cached keys pinned to one communicator (leak-check hook)."""
        with self._lock:
            return [k for k in self._d if k[0] == comms]


class _Seen:
    """A tensor field as a memo entry saw it: the tensor (weakly) and its
    version, which every in-place write advances."""

    __slots__ = ("ref", "version")

    def __init__(self, t: torch.Tensor):
        self.ref, self.version = weakref.ref(t), t._version

    def matches(self, t) -> bool:
        return self.ref() is t and self.version == t._version


def _stamp(obj):
    """``obj``'s dataclass fields as they are now (tensors as :class:`_Seen`),
    or None where a field could change unseen (an array that is no tensor)."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            v = _Seen(v)
        elif hasattr(v, "__array__"):
            return None
        out.append((f.name, v))
    return tuple(out)


def _unchanged(obj, stamp) -> bool:
    for name, seen in stamp:
        v = getattr(obj, name)
        if isinstance(seen, _Seen):
            if not seen.matches(v):
                return False
        elif isinstance(v, torch.Tensor) or not seen == v:
            return False
    return True


def memo(cache: ProgramCache, comms, tag: str, obj, build: Callable, *config):
    """``build()`` memoized in ``cache`` under ``(comms, tag, id(obj),
    *config)`` for as long as the dataclass ``obj`` lives and is unchanged:
    a weak reference to ``obj`` drops the entry when ``obj`` is collected
    (so an id reused by a later object never finds it), and a field
    replaced or a tensor field written in place since the entry was built
    builds it again. An object that is no dataclass, takes no weak
    reference or holds an array that is no tensor is not memoized."""
    if not dataclasses.is_dataclass(obj) or isinstance(obj, type):
        return build()
    stamp = _stamp(obj)
    if stamp is None:
        return build()
    key = (comms, tag, id(obj)) + tuple(config)
    try:
        ref = weakref.ref(obj, lambda _r, key=key: cache.discard(key))
    except TypeError:
        return build()
    return cache.get_or_build(key, lambda: (ref, stamp, build()),
                              lambda e: _unchanged(obj, e[1]))[2]
