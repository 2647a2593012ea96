"""Class-registry helpers (counterpart of mxnet_tpu/registry.py):
``get_register_func``, ``get_alias_func`` and ``get_create_func`` build a
name -> class registry per base class."""
from __future__ import annotations

import json

__all__ = ["get_registry", "get_register_func", "get_alias_func",
           "get_create_func"]

_REGISTRIES = {}


def get_registry(base_class):
    """A copy of the name -> class registry of ``base_class``."""
    return dict(_REGISTRIES.get(base_class, {}))


def get_register_func(base_class, nickname):
    """A ``register(klass, name=None)`` decorator for ``base_class``."""
    registry = _REGISTRIES.setdefault(base_class, {})

    def register(klass, name=None):
        assert issubclass(klass, base_class), \
            f"can only register subclasses of {base_class.__name__}"
        registry[(name or klass.__name__).lower()] = klass
        return klass

    register.__name__ = f"register_{nickname}"
    return register


def get_alias_func(base_class, nickname):
    """An ``alias(*names)`` class decorator."""
    register = get_register_func(base_class, nickname)

    def alias(*aliases):
        def reg(klass):
            for a in aliases:
                register(klass, a)
            return klass

        return reg

    alias.__name__ = f"alias_{nickname}"
    return alias


def get_create_func(base_class, nickname):
    """A ``create(name_or_instance, **kwargs)`` factory: an instance is
    returned as it is; a registered name, or a JSON ``'["name",
    {kwargs}]'`` string, is built."""
    registry = _REGISTRIES.setdefault(base_class, {})

    def create(*args, **kwargs):
        if args and isinstance(args[0], base_class):
            assert not kwargs and len(args) == 1
            return args[0]
        name = args[0] if args else kwargs.pop(nickname)
        if isinstance(name, str) and name.startswith("["):
            assert not kwargs and len(args) == 1
            name, kwargs = json.loads(name)
        key = name.lower()
        if key not in registry:
            raise ValueError(
                f"{name} is not registered as a {nickname}; known: "
                f"{sorted(registry)}")
        return registry[key](*args[1:], **kwargs)

    create.__name__ = f"create_{nickname}"
    return create
