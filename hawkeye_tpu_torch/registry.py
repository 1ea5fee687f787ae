"""Named registries for models / backbones / losses.

Reference: ``utils/repository.py:1-13`` — a ``dict`` subclass with a
``register`` decorator asserting name uniqueness; instances ``MODEL`` and
``BACKBONE`` live in ``model/registry.py:1-4``. We keep the identical public
surface (``.register``, ``.get``, dict behavior) and add an optional explicit
name argument.
"""

from __future__ import annotations


class Repository(dict):
    """A registry: ``@REPO.register`` adds a callable under its ``__name__``."""

    def __init__(self, name="repository"):
        super().__init__()
        self._name = name

    def register(self, obj=None, *, name=None):
        def _do_register(fn, key):
            assert key not in self, (
                f"{key!r} already registered in repository {self._name!r}"
            )
            self[key] = fn
            return fn

        if obj is None:  # used as @register(name="X")
            return lambda fn: _do_register(fn, name or fn.__name__)
        return _do_register(obj, name or obj.__name__)

    def get(self, key, default=None):
        if key in self:
            return self[key]
        if default is not None:
            return default
        raise KeyError(
            f"{key!r} not found in repository {self._name!r}. "
            f"Available: {sorted(self.keys())}"
        )


# Global registries (reference: model/registry.py:1-4)
MODEL = Repository("MODEL")
BACKBONE = Repository("BACKBONE")
LOSS = Repository("LOSS")
