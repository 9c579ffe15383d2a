"""Bounded LRU for compiled-program caches.

jit caches key on the function object, so modules keep step closures in
dicts to avoid recompiling epoch/serving programs per call. Unbounded,
those dicts grow one compiled XLA program per (mesh, hyperparameter)
combination for the life of a serving process —
this caps them with least-recently-used eviction. Evicted entries drop
the Python closure; XLA frees the underlying executable when its last
reference dies.
"""

from collections import OrderedDict


class LRUCache:
    """Minimal ordered-dict LRU: ``get`` refreshes recency, inserting
    past ``maxsize`` evicts the stalest entry."""

    def __init__(self, maxsize: int = 16):
        assert maxsize > 0
        self.maxsize = maxsize
        self._d: OrderedDict = OrderedDict()

    def get(self, key, default=None):
        try:
            self._d.move_to_end(key)
            return self._d[key]
        except KeyError:
            return default

    def __contains__(self, key):
        return key in self._d

    def __getitem__(self, key):
        self._d.move_to_end(key)
        return self._d[key]

    def __setitem__(self, key, value):
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)

    def __len__(self):
        return len(self._d)

    def clear(self):
        self._d.clear()
