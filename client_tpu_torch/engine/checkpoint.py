"""Model weight checkpoints in the JAX package's format.

Counterpart of ``client_tpu/engine/checkpoint.py``, which saves a params
pytree with orbax's ``StandardCheckpointer``. The port reads and writes the
same directories with torch, numpy and the standard library:

- ``_METADATA`` (JSON): the tree's leaves, keyed by the tuple of their
  path (``"('layers', '0', 'w1')"``), with each key's kind (1 a sequence
  index, 2 a dict key);
- ``manifest.ocdbt`` and its files: an OCDBT store (``engine/ocdbt.py``)
  holding each leaf as a zarr v2 array under its dotted path: the
  ``<path>/.zarray`` JSON and the chunks ``<path>/0.0``, each a zstd frame
  (``engine/zstd.py``);
- ``_CHECKPOINT_METADATA``, the handler and timestamps.

:func:`load_params` restores a tree shaped like ``like`` (leaves with a
``shape`` and a ``dtype``, torch's or numpy's; ``meta`` tensors do) as CPU
tensors. A bfloat16 array is read as its 16-bit patterns and viewed as
``torch.bfloat16``, so neither numpy nor ``ml_dtypes`` needs the type. As
in orbax, the tree's keys and each leaf's shape must match, and a stored
dtype that differs from ``like``'s is cast to it. :func:`save_params`
writes whole-array chunks in Raw zstd blocks: the format orbax reads,
without compression. Its leaves are typed as orbax types host arrays
(``np.ndarray``), which carry no device names: JAX restores them on any
platform, into concrete arrays or ``jax.eval_shape`` structures alike,
where a ``jax.Array`` leaf would need a ``_sharding`` entry naming a
device of the machine that restores it.
"""

from __future__ import annotations

import ast
import json
import math
import os
import time

import numpy as np
import torch

from client_tpu_torch.engine import ocdbt, zstd
from client_tpu_torch.engine.types import EngineError

_SEQ_KEY, _DICT_KEY = 1, 2

# zarr v2 dtype strings <-> torch dtypes; bfloat16 travels as int16 bits.
_ZARR_DTYPES = {
    "bfloat16": torch.bfloat16, "<f2": torch.float16, "<f4": torch.float32,
    "<f8": torch.float64, "|i1": torch.int8, "<i2": torch.int16,
    "<i4": torch.int32, "<i8": torch.int64, "|u1": torch.uint8,
    "|b1": torch.bool,
}
_TORCH_TO_ZARR = {v: k for k, v in _ZARR_DTYPES.items()}
_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")


def leaf_tensor(x) -> torch.Tensor:
    """A JAX params leaf as a tensor: a tensor as it is (bfloat16
    included), a numpy array as fp32 (numpy has no bfloat16 without
    ``ml_dtypes``; ``load_state_dict`` casts to each parameter's dtype)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy())


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name
    if name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, dtype=name)).dtype


def flatten(tree, kinds=()) -> list[tuple[tuple, tuple, object]]:
    """(path of string keys, ``(key, kind)`` pairs, leaf) for every leaf of
    a tree of dicts and lists, in orbax's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [e for k in sorted(tree, key=str)
                for e in flatten(tree[k], kinds + ((str(k), _DICT_KEY),))]
    if isinstance(tree, (list, tuple)):
        return [e for i, item in enumerate(tree)
                for e in flatten(item, kinds + ((str(i), _SEQ_KEY),))]
    return [(tuple(k for k, _ in kinds), kinds, tree)]


def _unflatten(like, values: dict[tuple, torch.Tensor], path=()):
    if isinstance(like, dict):
        return {k: _unflatten(v, values, path + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        items = [_unflatten(v, values, path + (str(i),))
                 for i, v in enumerate(like)]
        return items if isinstance(like, list) else tuple(items)
    return values[path]


def _mismatch(path: str, detail: str) -> EngineError:
    return EngineError(
        f"weights checkpoint '{path}' does not match the model's "
        f"parameter tree: {detail}", 400)


def _fill(fill_value, np_dtype: np.dtype, bf16: bool):
    if fill_value is None:
        return 0
    if isinstance(fill_value, str):
        fill_value = float(fill_value)  # "NaN", "Infinity", "-Infinity"
    if bf16:  # the bf16 pattern of the value, rounded to nearest even
        return torch.tensor(float(fill_value)).to(torch.bfloat16).view(
            torch.int16).item()
    return np.asarray(fill_value).astype(np_dtype)


def _read_array(store: ocdbt.Store, name: str) -> torch.Tensor:
    """The zarr v2 array stored under ``name`` as a CPU tensor."""
    meta = json.loads(store.read(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"'{name}': zarr format {meta.get('zarr_format')}")
    if meta.get("order", "C") != "C" or meta.get("filters"):
        raise ValueError(f"'{name}': only C order without filters is read")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"'{name}': compressor {comp.get('id')!r}")
    dtype = _ZARR_DTYPES.get(meta["dtype"])
    if dtype is None:
        raise ValueError(f"'{name}': dtype {meta['dtype']!r}")
    np_dt = np.dtype("<i2" if dtype == torch.bfloat16 else meta["dtype"])
    shape, chunks = list(meta["shape"]), list(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    fill = _fill(meta.get("fill_value"), np_dt, dtype == torch.bfloat16)
    grid = [math.ceil(s / c) if c else 0 for s, c in zip(shape, chunks)]
    out = None
    for idx in (np.ndindex(*grid) if shape else [()]):
        key = f"{name}/" + (sep.join(map(str, idx)) if idx else "0")
        if key not in store:
            continue  # a missing chunk is the fill value
        raw = store.read(key)
        if comp is not None:
            raw = zstd.decompress(raw)
        want = math.prod(chunks) * np_dt.itemsize
        if len(raw) != want:
            raise ValueError(f"'{key}': chunk is {len(raw)} bytes, "
                             f"expected {want}")
        chunk = np.frombuffer(raw, np_dt).reshape(chunks)
        if chunks == shape:  # one chunk holds the whole array
            out = chunk if chunk.flags.writeable else chunk.copy()
            break
        if out is None:
            out = np.full(shape, fill, np_dt)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[sl] = chunk[tuple(slice(0, x.stop - x.start) for x in sl)]
    if out is None:
        out = np.full(shape, fill, np_dt)
    t = torch.from_numpy(out)
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t


def load_params(path: str, like):
    """Restore a params tree matching the structure and shapes of
    ``like``; leaves come back as CPU tensors in ``like``'s dtypes."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise EngineError(f"weights checkpoint '{path}' not found", 400)
    try:
        with open(os.path.join(path, "_METADATA")) as f:
            tree_meta = json.load(f)["tree_metadata"]
        stored = {}
        for key, entry in tree_meta.items():
            keys = tuple(str(k) for k in ast.literal_eval(key))
            kinds = tuple(int(m["key_type"]) for m in entry["key_metadata"])
            stored[keys] = kinds
        store = ocdbt.Store(path)
    except (OSError, ValueError, KeyError, SyntaxError) as exc:
        raise _mismatch(path, f"{type(exc).__name__}: {exc}") from exc
    want = {p: (tuple(kt for _, kt in kinds), leaf)
            for p, kinds, leaf in flatten(like)}
    missing = sorted(".".join(p) for p in want.keys() - stored.keys())
    extra = sorted(".".join(p) for p in stored.keys() - want.keys())
    if missing or extra:
        raise _mismatch(path, f"keys missing from the checkpoint {missing}, "
                              f"keys not in the model {extra}")
    values = {}
    for p, (kinds, leaf) in want.items():
        name = ".".join(p)
        if stored[p] != kinds:
            raise _mismatch(path, f"'{name}': the checkpoint's containers "
                                  f"{stored[p]} differ from the model's "
                                  f"{kinds} (1 list, 2 dict)")
        try:
            arr = _read_array(store, name)
        except (OSError, ValueError, KeyError) as exc:
            raise _mismatch(path, f"{type(exc).__name__}: {exc}") from exc
        if tuple(arr.shape) != tuple(leaf.shape):
            raise _mismatch(path, f"'{name}': requested shape "
                                  f"{tuple(leaf.shape)} is not compatible "
                                  f"with the stored shape "
                                  f"{tuple(arr.shape)}")
        dtype = _torch_dtype(leaf.dtype)
        values[p] = arr if arr.dtype == dtype else arr.to(dtype)
    return _unflatten(like, values)


def save_params(path: str, params) -> str:
    """Write a params tree (torch tensors or numpy arrays) to ``path``
    (created; must not exist) as a checkpoint the JAX package's
    ``load_params`` restores."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        raise FileExistsError(f"checkpoint destination '{path}' exists")
    t0 = time.time_ns()
    leaves = flatten(params)
    items: dict[str, bytes] = {}
    tree_meta = {}
    for p, kinds, leaf in leaves:
        t = (leaf if isinstance(leaf, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(leaf)))
        t = t.detach().to("cpu").contiguous()
        if t.dtype not in _TORCH_TO_ZARR:
            raise TypeError(f"'{'.'.join(p)}': dtype {t.dtype} has no zarr "
                            "v2 name here")
        name = ".".join(p)
        shape = list(t.shape)
        items[f"{name}/.zarray"] = json.dumps({
            "chunks": shape, "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "dtype": _TORCH_TO_ZARR[t.dtype],
            "fill_value": None, "filters": None, "order": "C",
            "shape": shape, "zarr_format": 2}, separators=(",", ":")).encode()
        bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        items[f"{name}/" + (".".join("0" * len(shape)) if shape else "0")] = \
            zstd.compress_raw(bits.numpy().tobytes())
        tree_meta[repr(tuple(k for k, _ in kinds))] = {
            "key_metadata": [{"key": k, "key_type": kt} for k, kt in kinds],
            "value_metadata": {"value_type": "np.ndarray",
                               "skip_deserialize": False}}
    os.makedirs(path)
    ocdbt.write_store(path, items)

    def dump(rel: str, obj) -> None:
        os.makedirs(os.path.dirname(os.path.join(path, rel)), exist_ok=True)
        with open(os.path.join(path, rel), "w") as f:
            json.dump(obj, f)

    dump("_METADATA", {"tree_metadata": tree_meta, "use_ocdbt": True,
                       "use_zarr3": False,
                       "store_array_data_equal_to_fill_value": True,
                       "custom_metadata": None})
    dump("_CHECKPOINT_METADATA", {
        "item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {},
        "init_timestamp_nsecs": t0, "commit_timestamp_nsecs": time.time_ns(),
        "custom_metadata": {}})
    return path
