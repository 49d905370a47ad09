"""Model repository: registration, load/unload, index, directory loading.

Counterpart of ``ModelRepository`` in ``client_tpu/engine/repository.py``.
A model registers as a builder ``builder(device) -> ModelBackend``, one per
numbered version or one whose number comes from its config at load;
loading builds each served version on the engine's device and wraps it in
a :class:`~client_tpu_torch.engine.model.Model`, and unloading drops them,
so load and unload decide which weights are on the card.

:meth:`ModelRepository.from_directory` serves a Triton-style repository on
disk: one subdirectory per model with a ``config.pbtxt`` or a
``config.json``, numbered version subdirectories chosen by
``version_policy``. The file is the serving contract; the executable
backend comes from the port's zoo under the model's name (or
``parameters["zoo_builder"]``), and an ensemble needs none. A broken
config or name is contained per model: it shows UNAVAILABLE in the index
with its reason, and the rest of the directory loads. A model whose
weights are named (the ``weights_path`` parameter, or a
``<model>/<v>/weights`` directory) restores them from the JAX package's
checkpoint (``engine/checkpoint.py``) in place of the zoo's seeded init; a
checkpoint that is missing or does not match fails that model alone.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Callable

import torch

from client_tpu_torch.engine.backend_init import resolve_device
from client_tpu_torch.engine.model import Model, ModelBackend, restoring
from client_tpu_torch.engine.types import EngineError
from client_tpu_torch.utils import lockdep

Builder = Callable[[torch.device], ModelBackend]


class ConfigOnlyBackend(ModelBackend):
    """A backend that carries only its config: an ensemble runs through its
    composing models, so it never needs an executable."""

    def __init__(self, config):
        super().__init__()
        self.config = config

    def forward(self, inputs):
        raise EngineError(
            f"model '{self.config.name}' has no executable (platform "
            f"'{self.config.platform}' with no ensemble_scheduling steps)",
            400)


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


def _check_name(name: str) -> None:
    # ':' separates a name from its version in the engine's keys
    # ('name:v'): a model named 'm:1' would collide with version 1 of 'm'.
    if ":" in name:
        raise EngineError(
            f"invalid model name '{name}': ':' is reserved", 400)
    # '/' would make the name unreachable: every HTTP route takes it as one
    # path segment.
    if "/" in name:
        raise EngineError(
            f"invalid model name '{name}': '/' is reserved", 400)


class ModelRepository:
    """Versioned registry: each name maps to one or more numbered versions
    (the v2 route ``/v2/models/<m>/versions/<v>``). A registration without
    a number takes it from ``config.version`` at load; a directory model's
    versions are its numbered subdirectories, filtered by
    ``version_policy`` (latest N, all or specific; latest 1 by default)."""

    def __init__(self):
        # name -> {version-or-None: builder}; None = resolved at load.
        self._builders: dict[str, dict[int | None, Builder]] = {}
        self._loaded: dict[str, dict[int, Model]] = {}
        # name -> {builder key: resolved version} of the loaded set, so a
        # reload builds only the versions it does not hold yet.
        self._resolved: dict[str, dict[int | None, int]] = {}
        self._state: dict[str, tuple[str, str]] = {}  # name -> (state, reason)
        # name -> model directory: load() re-scans it, so a version
        # directory added after the first scan is served on the next load.
        self._dir_of: dict[str, str] = {}
        # One load at a time per name: load() builds outside the global
        # lock, and two loads of one name would both build its versions.
        self._load_locks: dict[str, threading.Lock] = {}
        self._lock = lockdep.RLock("engine.repository")

    def register(self, name: str, builder: Builder,
                 version: int | None = None) -> None:
        _check_name(name)
        with self._lock:
            self._builders.setdefault(name, {})[version] = builder
            self._state.setdefault(name, ("UNAVAILABLE", "unloaded"))

    def _set_builders(self, name: str,
                      mapping: dict[int | None, Builder]) -> None:
        """Replace ``name``'s builders wholesale (the re-scan path): a
        version that left the directory or the policy retires on the next
        load."""
        _check_name(name)
        with self._lock:
            self._builders[name] = dict(mapping)
            self._state.setdefault(name, ("UNAVAILABLE", "unloaded"))

    def load(self, name: str,
             device: str | torch.device | None = None) -> Model:
        """Build every served version of ``name`` on ``device`` (None means
        cuda); returns the latest.

        Loading a loaded model re-polls the repository: a directory model's
        directory is scanned again, versions registered since are built,
        versions that left the policy retire, and a version already built
        is kept as it is. If the reload fails, the old set keeps serving."""
        with self._lock:
            load_lock = self._load_locks.setdefault(name, lockdep.Lock("engine.repository.load"))
        with load_lock:
            return self._load_serialized(name, resolve_device(device))

    def _load_serialized(self, name: str, device: torch.device) -> Model:
        with self._lock:
            mdir = self._dir_of.get(name)
        if mdir and os.path.isdir(mdir):
            self._register_model_dir(mdir, os.path.basename(mdir))
        with self._lock:
            builders = self._builders.get(name)
            if not builders:
                raise EngineError(f"unknown model '{name}'", 404)
            builders = dict(builders)
            prev_resolved = dict(self._resolved.get(name, {}))
            prev_loaded = dict(self._loaded.get(name, {}))
            if prev_loaded and set(prev_resolved) == set(builders):
                # Nothing registered or retired since the last load.
                return prev_loaded[max(prev_loaded)]
            self._state[name] = ("LOADING", "")
        versions: dict[int, Model] = {}
        resolved: dict[int | None, int] = {}
        try:
            for ver, builder in sorted(builders.items(),
                                       key=lambda kv: kv[0] or 0):
                prev_v = prev_resolved.get(ver)
                if prev_v is not None and prev_v in prev_loaded:
                    versions[prev_v] = prev_loaded[prev_v]
                    resolved[ver] = prev_v
                    continue
                model = Model(builder(device), device=device)
                self._check_steps(model.config)
                v = ver if ver is not None else int(model.config.version)
                versions[v] = model
                resolved[ver] = v
        except Exception as exc:
            with self._lock:
                if prev_loaded:
                    self._state[name] = ("READY", "")  # the old set serves
                else:
                    self._state[name] = ("UNAVAILABLE", str(exc))
            raise
        with self._lock:
            self._loaded[name] = versions
            self._resolved[name] = resolved
            self._state[name] = ("READY", "")
        return versions[max(versions)]

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

    def unload(self, name: str, reason: str = "unloaded") -> None:
        """Drop every version; the index shows the model UNAVAILABLE with
        ``reason``."""
        with self._lock:
            if name not in self._builders:
                raise EngineError(f"unknown model '{name}'", 404)
            self._loaded.pop(name, None)
            self._resolved.pop(name, None)
            self._state[name] = ("UNAVAILABLE", reason)

    def get(self, name: str, version: str | int = "") -> Model | None:
        v = _parse_version(version)
        with self._lock:
            vs = self._loaded.get(name)
            if not vs:
                return None
            if v is None:
                return vs[max(vs)]
            return vs.get(v)

    def loaded_versions(self, name: str) -> dict[int, Model]:
        with self._lock:
            return dict(self._loaded.get(name, {}))

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._builders)

    def is_ready(self, name: str, version: str | int = "") -> bool:
        try:
            return self.get(name, version) is not None
        except EngineError:
            return False

    # -- directory repository ------------------------------------------------

    @classmethod
    def from_directory(cls, path: str) -> "ModelRepository":
        repo = cls()
        repo.add_directory(path)
        return repo

    def add_directory(self, path: str) -> list[str]:
        """Register every model subdirectory of ``path``; returns the names.

        Layout per model: ``<path>/<name>/config.pbtxt`` (or
        ``config.json``), numbered version directories, and any label file
        an output names in ``label_filename`` (read into
        ``parameters["labels"][output]`` for the classification
        extension)."""
        if not os.path.isdir(path):
            raise EngineError(f"model repository '{path}' is not a directory",
                              404)
        names = []
        for entry in sorted(os.listdir(path)):
            mdir = os.path.join(path, entry)
            if not os.path.isdir(mdir):
                continue
            name = self._register_model_dir(mdir, entry)
            if name is not None:
                names.append(name)
        return names

    def _register_model_dir(self, mdir: str, entry: str) -> str | None:
        """(Re-)register one model directory; returns the model name, or
        None when the directory holds no config. A config that does not
        parse, a bad name or a bad version policy registers a failing
        builder, so the index shows the model UNAVAILABLE with its reason
        and the rest of the repository loads."""
        try:
            d = self._read_config(mdir)
        except Exception as exc:  # noqa: BLE001 — surfaced per model
            return self._register_broken(
                entry, f"failed to parse config in '{mdir}': {exc}")
        if d is None:
            return None
        if not d.get("name"):
            d["name"] = entry  # the directory name is canonical
        try:
            _check_name(d["name"])
        except EngineError as exc:
            return self._register_broken(entry, str(exc))
        self._resolve_labels(d, mdir)
        d["_model_dir"] = mdir  # for a relative weights_path
        found = sorted(
            int(e) for e in os.listdir(mdir)
            if e.isdigit() and int(e) > 0
            and os.path.isdir(os.path.join(mdir, e)))
        try:
            if found:
                self._set_builders(d["name"], {
                    v: _directory_builder(d, v)
                    for v in _apply_version_policy(
                        found, d.get("version_policy"))})
            else:
                self._set_builders(d["name"], {None: _directory_builder(d)})
        except EngineError as exc:  # a bad version_policy
            return self._register_broken(d["name"], str(exc))
        with self._lock:
            self._dir_of[d["name"]] = mdir
        return d["name"]

    def _register_broken(self, entry: str, msg: str) -> str | None:
        """Register a builder that fails with ``msg`` under the directory
        name; a directory name that cannot be a model name is logged and
        skipped."""
        try:
            self._set_builders(entry, {None: _failing_builder(msg)})
        except EngineError:
            logging.getLogger("client_tpu_torch").warning(
                "skipping model directory '%s': %s", entry, msg)
            return None
        return entry

    @staticmethod
    def _read_config(mdir: str) -> dict | None:
        pbtxt = os.path.join(mdir, "config.pbtxt")
        cfg_json = os.path.join(mdir, "config.json")
        if os.path.exists(pbtxt):
            from client_tpu_torch.protocol.model_config import load_pbtxt

            return load_pbtxt(pbtxt)
        if os.path.exists(cfg_json):
            with open(cfg_json) as f:
                return json.load(f)
        return None

    @staticmethod
    def _resolve_labels(d: dict, mdir: str) -> None:
        labels = {}
        for out in d.get("output", []):
            fname = out.get("label_filename")
            if not fname:
                continue
            fpath = os.path.join(mdir, fname)
            if os.path.exists(fpath):
                with open(fpath) as f:
                    labels[out["name"]] = [ln.rstrip("\n") for ln in f]
        if labels:
            d.setdefault("parameters", {}).setdefault("labels", {}).update(
                labels)

    def index(self) -> list[dict]:
        """Repository index rows: one per loaded version; a model that is
        not loaded gets one row with its highest registered version ("1"
        when none is numbered), its state and its reason."""
        with self._lock:
            out = []
            for name in sorted(self._builders):
                state, reason = self._state.get(name, ("UNAVAILABLE", ""))
                loaded = self._loaded.get(name)
                if loaded:
                    for v in sorted(loaded):
                        out.append({"name": name, "version": str(v),
                                    "state": state})
                    continue
                versions = [v for v in self._builders[name] if v is not None]
                entry = {"name": name,
                         "version": str(max(versions)) if versions else "1",
                         "state": state}
                if reason:
                    entry["reason"] = reason
                out.append(entry)
            return out


def _apply_version_policy(found: list[int], policy) -> list[int]:
    """Triton's version_policy over the numbered subdirectories:
    ``latest {num_versions: N}`` (N = 1 by default), ``all {}`` or
    ``specific {versions: [...]}``."""
    if not policy or not isinstance(policy, dict):
        return found[-1:]
    if "all" in policy:
        return found
    if "specific" in policy:
        want = (policy["specific"] or {}).get("versions", [])
        if not isinstance(want, list):
            want = [want]
        want = {int(v) for v in want}
        missing = want - set(found)
        if missing:
            raise EngineError(
                f"version_policy.specific requests versions "
                f"{sorted(missing)} with no version directory", 400)
        return sorted(want)
    if "latest" in policy:
        n = int((policy["latest"] or {}).get("num_versions", 1))
        return found[-max(1, n):]
    raise EngineError(f"unknown version_policy {sorted(policy)}", 400)


def _failing_builder(message: str) -> Builder:
    def build(device: torch.device) -> ModelBackend:
        raise EngineError(message, 400)

    return build


def _directory_builder(d: dict, version: int | None = None) -> Builder:
    """Builder of a config-file model: the file is the serving contract and
    the port's zoo supplies the executable, under the model's name or
    ``parameters["zoo_builder"]``. With ``version`` the model serves as
    that numbered version. Weights named for it (the ``weights_path``
    parameter, relative paths resolved against the version directory
    first, then the model directory; or a ``<model>/<v>/weights``
    directory) are restored from that checkpoint instead of the zoo's
    seeded init, as the JAX package restores them."""

    def build(device: torch.device) -> ModelBackend:
        from client_tpu_torch.engine.config import ModelConfig

        cfg = ModelConfig.from_dict(d)
        if version is not None:
            cfg.version = version
        if cfg.platform == "ensemble" and not cfg.ensemble_scheduling:
            raise EngineError(
                f"model '{cfg.name}': platform 'ensemble' requires "
                "ensemble_scheduling steps", 400)
        if cfg.ensemble_scheduling:
            return ConfigOnlyBackend(cfg)

        mdir = d.get("_model_dir", "")
        vdir = os.path.join(mdir, str(version)) if version is not None else ""
        wp = cfg.parameters.get("weights_path")
        if wp:
            wp = str(wp)
            if not os.path.isabs(wp):
                cand = os.path.join(vdir, wp) if vdir else ""
                wp = (cand if cand and os.path.isdir(cand)
                      else os.path.join(mdir, wp))
        elif vdir and os.path.isdir(os.path.join(vdir, "weights")):
            wp = os.path.join(vdir, "weights")

        import client_tpu_torch.models as zoo

        zoo._import_all()
        builder_name = str(cfg.parameters.get("zoo_builder", cfg.name))
        builder = zoo._REGISTRY.get(builder_name)
        if builder is None:
            raise EngineError(
                f"no executable backend for model '{cfg.name}' (platform "
                f"'{cfg.platform}'): register one with "
                f"client_tpu_torch.models.register_model('{builder_name}') "
                "or set parameters.zoo_builder in its config", 400)
        with restoring(wp or None):
            backend = builder(device)
        # The file's config is authoritative; a bucket ladder is not
        # expressible in pbtxt, so the zoo's carries over when the batch
        # limit agrees.
        if (cfg.batch_buckets is None
                and backend.config.max_batch_size == cfg.max_batch_size):
            cfg.batch_buckets = backend.config.batch_buckets
        backend.config = cfg
        return backend

    return build
