"""Frozen-dataclass pytrees for blocks and their configs.

``class Fir(PyTreeNode)`` makes ``Fir`` a frozen dataclass registered with
``jax.tree_util.register_dataclass``: fields are pytree leaves (arrays,
nested blocks) unless declared ``field(pytree_node=False)``, which makes
them static metadata — part of the jit cache key, never traced.
"""
from __future__ import annotations

import dataclasses
from typing import TypeVar

import jax

T = TypeVar("T", bound="PyTreeNode")


def field(pytree_node: bool = True, **kwargs):
    """``dataclasses.field`` with a ``pytree_node`` flag: False marks the
    field static (hashable config, not a traced leaf)."""
    return dataclasses.field(metadata={"pytree_node": pytree_node}, **kwargs)


class PyTreeNode:
    """Base class: every subclass becomes a frozen, registered dataclass."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__()
        dataclasses.dataclass(frozen=True, **kwargs)(cls)
        fields = dataclasses.fields(cls)
        data = [f.name for f in fields if f.metadata.get("pytree_node", True)]
        meta = [f.name for f in fields
                if not f.metadata.get("pytree_node", True)]
        jax.tree_util.register_dataclass(cls, data_fields=data,
                                         meta_fields=meta)

    def replace(self: T, **updates) -> T:
        """A copy with the given fields replaced."""
        return dataclasses.replace(self, **updates)
