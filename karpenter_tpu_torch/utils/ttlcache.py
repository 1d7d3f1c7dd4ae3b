"""TTL cache (the go-cache analog the reference uses for preference
relaxation and cloud-provider catalog caching).

Expiry is computed against an injectable clock so tests can fast-forward.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple


class TTLCache:
    def __init__(self, ttl: float, clock: Optional[Callable[[], float]] = None):
        self.ttl = ttl
        self.clock = clock or time.time
        self._lock = threading.Lock()
        self._items: Dict[Any, Tuple[float, Any]] = {}  # key -> (expiry, value); guarded-by: self._lock

    def get(self, key) -> Optional[Any]:
        now = self.clock()
        with self._lock:
            entry = self._items.get(key)
            if entry is None:
                return None
            expiry, value = entry
            if now >= expiry:
                del self._items[key]
                return None
            return value

    def set(self, key, value, ttl: Optional[float] = None) -> None:
        with self._lock:
            self._items[key] = (self.clock() + (ttl if ttl is not None else self.ttl), value)

    def delete(self, key) -> None:
        with self._lock:
            self._items.pop(key, None)

    def get_or_compute(self, key, compute: Callable[[], Any]) -> Any:
        cached = self.get(key)
        if cached is not None:
            return cached
        value = compute()
        self.set(key, value)
        return value

    def keys(self):
        now = self.clock()
        with self._lock:
            return [k for k, (exp, _) in self._items.items() if now < exp]

    def clear(self) -> None:
        with self._lock:
            self._items.clear()
