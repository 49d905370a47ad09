"""The port's model zoo and its registry.

Counterpart of ``client_tpu/models/__init__.py``, with a registry of its
own: a builder registered here is ``builder(device) -> ModelBackend`` and
never reaches the JAX package's zoo.
"""

from __future__ import annotations

from typing import Callable

from client_tpu_torch.engine.repository import Builder, ModelRepository

_REGISTRY: dict[str, Builder] = {}
_NON_DEFAULT: set[str] = set()  # loadable by name, left out of "all"


def register_model(name: str, default: bool = True
                   ) -> Callable[[Builder], Builder]:
    def deco(builder: Builder) -> Builder:
        _REGISTRY[name] = builder
        if not default:
            _NON_DEFAULT.add(name)
        return builder
    return deco


def _import_all() -> None:
    from client_tpu_torch.models import (  # noqa: F401
        bert,
        dlrm,
        ensembles,
        generate,
        simple,
        ssd,
        vision,
    )
    # The sharded (*_mc) families register themselves, as in the JAX zoo.
    from client_tpu_torch.parallel import serving  # noqa: F401


def model_names() -> list[str]:
    _import_all()
    return sorted(_REGISTRY)


def build_repository(names: list[str] | None = None) -> ModelRepository:
    """A repository with the named zoo models registered (every default
    model when ``names`` is None); raises KeyError for an unknown name."""
    _import_all()
    unknown = sorted(set(names or ()) - set(_REGISTRY))
    if unknown:
        raise KeyError(f"unknown zoo model(s) {unknown}; "
                       f"available: {', '.join(sorted(_REGISTRY))}")
    repo = ModelRepository()
    for name, builder in _REGISTRY.items():
        if (name in names) if names is not None else name not in _NON_DEFAULT:
            repo.register(name, builder)
    return repo
