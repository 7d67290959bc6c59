"""Values made from weights that the caller holds fixed over a scope.

An image's chunks and a bake sweep's batches run each layer chain on the
same weights, so what is made from them alone (a kernel's packed layout, a
layer's cast to the compute dtype) is made once a scope: ``cached`` inside
a ``weights_fixed()`` scope. Used by the kernel wrappers
(ops/cuda/pe_mlp.py, ops/cuda/field_head.py) and the plain layer chains of
the hash fields (fields/nerfacto.py).
"""

from __future__ import annotations

import contextlib
import threading

_SCOPE = threading.local()


@contextlib.contextmanager
def weights_fixed():
    """A scope over which the caller holds the weights fixed, as an image's
    chunks or a bake sweep's batches do: inside it `cached` makes each value
    once. Its store is the calling thread's, shared by nested scopes, and
    dropped when the outer one ends. (An in-place update has no reliable
    trace to key on: the fused Adam step leaves a tensor's version counter
    as it was.)"""
    outer = getattr(_SCOPE, "store", None)
    if outer is None:
        _SCOPE.store = {}
    try:
        yield
    finally:
        if outer is None:
            _SCOPE.store = None


def cached(what, tensors, make):
    """make(), once for `what` and these tensors inside a weights_fixed()
    scope; outside one, anew every call."""
    store = getattr(_SCOPE, "store", None)
    if store is None:
        return make()
    key = (what, tuple(id(t) for t in tensors))
    kept = store.get(key)
    if kept is None or not all(a is b for a, b in zip(kept[0], tensors)):
        kept = store[key] = (list(tensors), make())
    return kept[1]
