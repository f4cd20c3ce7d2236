"""Frozen dataclasses registered as JAX pytrees.

``@dataclass`` makes every field a pytree leaf (array data) except those
declared with ``static_field()``, which become part of the tree structure
(hashable metadata: a different value compiles a different program).
Instances are immutable; ``.replace(**changes)`` returns an updated copy.
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(**kwargs):
    """A field kept in the pytree structure instead of its leaves."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = _replace
    return jax.tree_util.register_dataclass(cls)
