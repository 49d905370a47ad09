"""Model repository: registration by builder, and load.

Counterpart of ``ModelRepository`` in ``client_tpu/engine/repository.py``.
A model registers as a builder ``builder(device) -> ModelBackend``; loading
builds the backend on the engine's device and wraps it in one
:class:`~client_tpu_torch.engine.model.Model`. Unload, directory
repositories (``config.pbtxt``) and multiple versions per name are not
ported yet. :func:`_parse_version` reads a requested version as
the reference does, with its codes and words.
"""

from __future__ import annotations

import threading
from typing import Callable

import torch

from client_tpu_torch.engine.model import Model, ModelBackend
from client_tpu_torch.engine.types import EngineError

Builder = Callable[[torch.device], ModelBackend]


def _parse_version(version) -> int | None:
    """'' / None -> None (latest); otherwise a positive int."""
    if version is None:
        return None
    v = str(version).strip()
    if not v:
        return None
    try:
        n = int(v)
    except ValueError:
        raise EngineError(f"invalid model version '{version}'", 400) from None
    if n < 1:
        raise EngineError(f"invalid model version '{version}'", 400)
    return n


class ModelRepository:
    def __init__(self):
        self._builders: dict[str, Builder] = {}
        self._loaded: dict[str, Model] = {}
        self._state: dict[str, tuple[str, str]] = {}  # name -> (state, reason)
        self._lock = threading.Lock()

    def register(self, name: str, builder: Builder) -> None:
        if ":" in name or "/" in name:
            raise EngineError(
                f"invalid model name '{name}': ':' and '/' are reserved", 400)
        with self._lock:
            self._builders[name] = builder
            self._state.setdefault(name, ("UNAVAILABLE", "unloaded"))

    def load(self, name: str, device: torch.device) -> Model:
        """Build ``name`` on ``device`` (a loaded model is kept as is)."""
        with self._lock:
            builder = self._builders.get(name)
            if builder is None:
                raise EngineError(f"unknown model '{name}'", 404)
            if name in self._loaded:
                return self._loaded[name]
            self._state[name] = ("LOADING", "")
        try:
            model = Model(builder(device), device=device)
            self._check_steps(model.config)
        except Exception as exc:
            with self._lock:
                self._state[name] = ("UNAVAILABLE", str(exc))
            raise
        with self._lock:
            self._loaded[name] = model
            self._state[name] = ("READY", "")
        return model

    def _check_steps(self, cfg) -> None:
        """An ensemble loads only when every composing model it names is
        registered: a missing step is a load error, not a failure of the
        first request."""
        with self._lock:
            missing = sorted({s.model_name for s in cfg.ensemble_scheduling}
                             - set(self._builders))
        if missing:
            raise EngineError(
                f"ensemble '{cfg.name}' names model(s) {missing} that are "
                "not in the repository", 400)

    def get(self, name: str) -> Model | None:
        with self._lock:
            return self._loaded.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._builders)

    def index(self) -> list[dict]:
        """Repository index entries: name, version, state, reason."""
        with self._lock:
            out = []
            for name in sorted(self._builders):
                state, reason = self._state[name]
                entry = {"name": name, "state": state}
                model = self._loaded.get(name)
                if model is not None:
                    entry["version"] = str(model.config.version)
                if reason:
                    entry["reason"] = reason
                out.append(entry)
            return out
