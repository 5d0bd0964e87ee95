"""Global LRU image cache holding device-resident float32 planes.

Device analog of the reference's ORIG/KEY cache
(reference: src-tauri/src/infra/cache.rs): entries are jax.Arrays (the
device is the backing store — its memory instead of host RAM), with optional
ImageStats and header attached. Composite (`__composite_*`), wizard
(`__wizard_ch_*`) and star-mask keys are pinned and never evicted
(cache.rs:90-92). Eviction is generation-counter LRU with byte and
entry caps (cache.rs:306-310). Stats/header upgrade paths preserved
(cache.rs:245-269).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from astroburst_tpu.constants import STAR_MASK_KEY, WIZARD_CACHE_PREFIX
from astroburst_tpu.dtypes import ImageStats
from astroburst_tpu.errors import CacheMiss
from astroburst_tpu.io.header import HduHeader

DEFAULT_MAX_ENTRIES = 32
DEFAULT_MAX_BYTES = 2 * 1024 * 1024 * 1024  # cache.rs:306-310


def is_pinned_key(key: str) -> bool:
    return key.startswith("__composite") or key.startswith(
        WIZARD_CACHE_PREFIX) or key == STAR_MASK_KEY


@dataclass
class CacheEntry:
    image: jax.Array                      # f32 [H, W] on device
    stats: Optional[ImageStats] = None
    header: Optional[HduHeader] = None
    generation: int = 0

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.image.shape)) * 4


class ImageCache:
    """Thread-safe LRU of device arrays with pinned keys."""

    def __init__(self, max_entries: int = DEFAULT_MAX_ENTRIES,
                 max_bytes: int = DEFAULT_MAX_BYTES):
        self._lock = threading.RLock()
        self._entries: Dict[str, CacheEntry] = {}
        self._gen = 0
        self.max_entries = max_entries
        self.max_bytes = max_bytes

    # -- core ---------------------------------------------------------------

    def _touch(self, entry: CacheEntry) -> None:
        self._gen += 1
        entry.generation = self._gen

    def _evict_if_needed(self) -> None:
        def evictable():
            return [k for k in self._entries if not is_pinned_key(k)]

        while len(self._entries) > self.max_entries:
            victims = evictable()
            if not victims:
                break  # everything pinned: never loop forever (cache.rs:432)
            oldest = min(victims, key=lambda k: self._entries[k].generation)
            del self._entries[oldest]
        while sum(e.nbytes for e in self._entries.values()) > self.max_bytes:
            victims = evictable()
            if not victims:
                break
            oldest = min(victims, key=lambda k: self._entries[k].generation)
            del self._entries[oldest]

    def insert(self, key: str, image, stats: Optional[ImageStats] = None,
               header: Optional[HduHeader] = None) -> CacheEntry:
        arr = _to_device_f32(image)
        with self._lock:
            entry = CacheEntry(arr, stats, header)
            self._touch(entry)
            self._entries[key] = entry
            self._evict_if_needed()
            return entry

    def get(self, key: str) -> Optional[CacheEntry]:
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                self._touch(e)
            return e

    def require(self, key: str) -> CacheEntry:
        e = self.get(key)
        if e is None:
            raise CacheMiss(f"cache key not found: {key}")
        return e

    def contains(self, key: str) -> bool:
        with self._lock:
            return key in self._entries

    def remove(self, key: str) -> None:
        with self._lock:
            self._entries.pop(key, None)

    def remove_prefix(self, prefix: str) -> int:
        with self._lock:
            victims = [k for k in self._entries if k.startswith(prefix)]
            for k in victims:
                del self._entries[k]
            return len(victims)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def keys(self):
        with self._lock:
            return list(self._entries.keys())

    # -- upgrade paths (cache.rs:245-269) ------------------------------------

    def upgrade_stats(self, key: str, stats: ImageStats) -> None:
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e.stats is None:
                e.stats = stats

    def upgrade_header(self, key: str, header: HduHeader) -> None:
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e.header is None:
                e.header = header

    def get_or_load(self, key: str,
                    loader: Callable[[], Tuple[object, Optional[ImageStats],
                                               Optional[HduHeader]]]) -> CacheEntry:
        """Return cached entry or load-and-insert (cache.rs:183)."""
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                self._touch(e)
                return e
        image, stats, header = loader()
        return self.insert(key, image, stats, header)


def _to_device_f32(image) -> jax.Array:
    if isinstance(image, jax.Array) and image.dtype == jnp.float32:
        return image
    return jnp.asarray(np.asarray(image), dtype=jnp.float32)


GLOBAL_IMAGE_CACHE = ImageCache()
