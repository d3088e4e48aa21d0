"""Lazy-evaluation record: thunks forced once, then cached.

Port of `rollout_bo_tpu/utils/lazy.py`, the analog of the reference's
`LazyStruct` (lazy_struct.jl:15-62), the Dict-backed lazy record behind
every posterior evaluation there. It is host-side Python: forcing a
quantity once (a factorization feeding several derived statistics) does
not recompute it, and it backs `models.surrogate.lazy_posterior`.

Usage (mirrors lazy_struct.jl semantics):

    s = LazyStruct()
    s.mu = lambda: expensive_mean()      # set a thunk
    s.set("sigma", lambda: expensive_std())
    s.mu                                 # forces + caches
    s.mu                                 # cached
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["LazyStruct"]


class LazyStruct:
    """Attribute access forces and caches zero-arg thunks.

    reference: setproperty! stores the thunk (lazy_struct.jl:29-33),
    getproperty forces it once and memoizes (lazy_struct.jl:43-53),
    `set` is the explicit-thunk form (lazy_struct.jl:60-62).
    """

    __slots__ = ("_thunks", "_cache")

    def __init__(self, **thunks: Callable[[], Any]):
        object.__setattr__(self, "_thunks", dict(thunks))
        object.__setattr__(self, "_cache", {})

    def set(self, name: str, thunk: Callable[[], Any]) -> None:
        self._thunks[name] = thunk
        self._cache.pop(name, None)

    def __setattr__(self, name: str, thunk: Callable[[], Any]) -> None:
        if not callable(thunk):
            raise TypeError(
                f"LazyStruct properties are zero-arg thunks; got {type(thunk).__name__} "
                f"for {name!r} (wrap constants as `lambda: value`)"
            )
        self.set(name, thunk)

    def __getattr__(self, name: str) -> Any:
        # __getattr__ only fires for names not found normally, so _thunks /
        # _cache lookups via object.__getattribute__ stay fast.
        cache = object.__getattribute__(self, "_cache")
        if name in cache:
            return cache[name]
        thunks = object.__getattribute__(self, "_thunks")
        if name in thunks:
            value = thunks[name]()
            cache[name] = value
            return value
        raise AttributeError(f"LazyStruct has no property {name!r}")

    def __contains__(self, name: str) -> bool:
        return name in self._thunks

    def keys(self):
        return self._thunks.keys()

    def forced(self) -> dict:
        """Names already forced (for tests / cache inspection)."""
        return dict(self._cache)
