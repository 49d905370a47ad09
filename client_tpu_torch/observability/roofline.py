"""Roofline attribution: counted FLOPs and bytes joined to measured time.

The port's counterpart of ``client_tpu/observability/roofline.py``. The
profiler measures how long a bucket runs on the card; this module
supplies the numerator (FLOPs and bytes of one execution) and the
denominator (the card's peak rates), so the profiler can turn device
seconds into achieved FLOP/s and bytes/s, arithmetic intensity, MFU and
MBU per (model, version, bucket).

Where JAX reads XLA's cost analysis from a lowering, the port counts a
bucket's first execution (:class:`CostCapture`), never a later one:

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the forward,
  plus what each hand-written kernel reports through
  :func:`kernel_work`. The kernels run through ``ctypes``, where the
  counter sees nothing, so each wrapper reports its own FLOPs by its
  formula when it launches; on the CPU the plain version runs as torch
  ops, which the counter counts, and the wrapper reports no FLOPs.
- ``bytes_accessed``: the bytes of the backend's parameters and buffers
  (each read once; a table read by a gather, an embedding or
  ``index_select``, counts only the rows the batch gathers), plus each
  hand-written kernel's bytes by its formula, plus the execution's input
  and output bytes. Activations between the other operations are not
  counted, so this is a lower bound of the bytes an execution moves.

Capture never switches a tensor to another device or path: it watches
the execution the request runs anyway.

The peak registry has one row, an NVIDIA H100 SXM, keyed by the name
``torch.cuda.get_device_name()`` returns; ``CLIENT_TPU_ROOFLINE``
overrides the peaks as in the JAX package. Without a known card (the
CPU) the peaks are unknown and every ratio is None.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass

from client_tpu_torch.config import env_text

ENV_VAR = "CLIENT_TPU_ROOFLINE"


@dataclass(frozen=True)
class PeakSpec:
    """Per-chip peak rates. Either field may be None (partially known
    hardware): the ratios that need it degrade to None, the others
    still compute."""

    flops_per_s: float | None   # dense bf16 peak FLOP/s per chip
    bytes_per_s: float | None   # peak HBM bandwidth, bytes/s per chip
    source: str = "registry"

    def ridge(self) -> float | None:
        """Arithmetic intensity (flops/byte) at which the roofline
        bends: below it a kernel is bandwidth-bound, above compute."""
        if not self.flops_per_s or not self.bytes_per_s:
            return None
        return self.flops_per_s / self.bytes_per_s

    def as_dict(self) -> dict:
        return {"flops_per_s": self.flops_per_s,
                "bytes_per_s": self.bytes_per_s,
                "source": self.source}


# Peak rates per card, keyed by the lowercased name
# ``torch.cuda.get_device_name()`` reports. NVIDIA H100 SXM data sheet:
# 989 TFLOP/s dense bf16 (no sparsity) and 3.35 TB/s of HBM3, at the
# part's full 700 W power limit.
PEAK_SPECS: dict[str, PeakSpec] = {
    "nvidia h100 80gb hbm3": PeakSpec(989e12, 3.35e12),
}


# -- CLIENT_TPU_ROOFLINE ------------------------------------------------------


@dataclass
class RooflineConfig:
    """``CLIENT_TPU_ROOFLINE`` knobs. Grammar matches the other
    observability knobs, defaulting ON: unset/``1``/``on`` captures with
    registry peaks, ``0``/``off`` disables capture, else inline JSON or
    ``@file`` with ``peak_flops`` / ``peak_bytes_per_s`` (forces the
    peaks regardless of detected kind — the only way to get MFU on a
    CPU dev host) and/or ``device_kinds`` (extra registry rows:
    ``{"kind": {"peak_flops": ..., "peak_bytes_per_s": ...}}``)."""

    capture: bool = True
    peak_flops: float | None = None
    peak_bytes_per_s: float | None = None
    device_kinds: dict[str, PeakSpec] | None = None

    @classmethod
    def from_dict(cls, data: dict) -> "RooflineConfig":
        known = {"capture", "peak_flops", "peak_bytes_per_s",
                 "device_kinds"}
        unknown = set(data) - known
        if unknown:
            raise ValueError(
                f"{ENV_VAR}: unknown key(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        cfg = cls()
        if "capture" in data:
            if not isinstance(data["capture"], bool):
                raise ValueError(
                    f"{ENV_VAR}: key 'capture' expects a boolean, "
                    f"got {data['capture']!r}")
            cfg.capture = data["capture"]
        for key in ("peak_flops", "peak_bytes_per_s"):
            if key in data:
                setattr(cfg, key, _positive_number(key, data[key]))
        if "device_kinds" in data:
            kinds = data["device_kinds"]
            if not isinstance(kinds, dict):
                raise ValueError(
                    f"{ENV_VAR}: key 'device_kinds' expects an object")
            cfg.device_kinds = {}
            for kind, spec in kinds.items():
                if not isinstance(spec, dict):
                    raise ValueError(
                        f"{ENV_VAR}: device_kinds[{kind!r}] expects an "
                        "object with peak_flops / peak_bytes_per_s")
                extra = set(spec) - {"peak_flops", "peak_bytes_per_s"}
                if extra:
                    raise ValueError(
                        f"{ENV_VAR}: device_kinds[{kind!r}] unknown "
                        f"key(s) {sorted(extra)}")
                cfg.device_kinds[kind.strip().lower()] = PeakSpec(
                    _positive_number(f"device_kinds[{kind!r}].peak_flops",
                                     spec["peak_flops"])
                    if "peak_flops" in spec else None,
                    _positive_number(
                        f"device_kinds[{kind!r}].peak_bytes_per_s",
                        spec["peak_bytes_per_s"])
                    if "peak_bytes_per_s" in spec else None,
                    source="env")
        return cfg

    @classmethod
    def from_env(cls, environ=None) -> "RooflineConfig":
        raw = env_text(ENV_VAR, environ)
        if raw.lower() in ("0", "false", "off"):
            return cls(capture=False)
        if not raw or raw.lower() in ("1", "true", "on"):
            return cls()
        if raw.startswith("@"):
            try:
                with open(raw[1:]) as f:
                    raw = f.read()
            except OSError as exc:
                raise ValueError(
                    f"{ENV_VAR}: cannot read '{raw[1:]}': {exc}") from None
        try:
            data = json.loads(raw)
        except json.JSONDecodeError as exc:
            raise ValueError(f"{ENV_VAR}: invalid JSON ({exc})") from None
        if not isinstance(data, dict):
            raise ValueError(f"{ENV_VAR}: expected a JSON object")
        return cls.from_dict(data)

    def resolve_peaks(self, device_kind: str) -> PeakSpec | None:
        """Peaks for a detected kind: an explicit env ``peak_flops`` /
        ``peak_bytes_per_s`` pair wins outright (that is the CPU-host
        escape hatch), then env ``device_kinds`` rows, then the built-in
        registry; None when nothing matches (``peaks: unknown``)."""
        if self.peak_flops is not None or self.peak_bytes_per_s is not None:
            return PeakSpec(self.peak_flops, self.peak_bytes_per_s,
                            source="env")
        kind = device_kind.strip().lower()
        for table, src in ((self.device_kinds or {}, "env"),
                           (PEAK_SPECS, "registry")):
            spec = table.get(kind)
            if spec is None:
                # Substring match: a registry key names a part whose
                # reported name may carry more words.
                for key, candidate in table.items():
                    if key and key in kind:
                        spec = candidate
                        break
            if spec is not None:
                return PeakSpec(spec.flops_per_s, spec.bytes_per_s,
                                source=src)
        return None


def _positive_number(key: str, raw) -> float:
    if isinstance(raw, bool) or not isinstance(raw, (int, float)):
        raise ValueError(f"{ENV_VAR}: key '{key}' expects a number, "
                         f"got {raw!r}")
    value = float(raw)
    if value <= 0:
        raise ValueError(f"{ENV_VAR}: key '{key}' must be > 0")
    return value


def roofline_config(environ=None) -> RooflineConfig:
    """Parse ``CLIENT_TPU_ROOFLINE`` (fresh each call). Raises ValueError
    on a malformed value; the engine resolves it once at start so an
    operator's typo fails the boot, while the snapshot path annotates
    instead."""
    return RooflineConfig.from_env(environ)


# -- device detection ---------------------------------------------------------

_detected_kind: str | None = None


def detect_device_kind() -> str:
    """The name of card 0 ("NVIDIA H100 80GB HBM3"), or "cpu" without
    CUDA; cached for the process."""
    global _detected_kind
    if _detected_kind is None:
        import torch

        _detected_kind = (torch.cuda.get_device_name(0)
                          if torch.cuda.is_available() else "cpu")
    return _detected_kind


def roofline_context(environ=None) -> dict:
    """The resolved roofline environment for snapshot headers:
    ``{"device_kind", "peaks": {...} | "unknown"}``, with a
    ``config_error`` annotation in place of a raise when the knob is
    malformed (the profile must render regardless)."""
    try:
        cfg = roofline_config(environ)
    except ValueError as exc:
        return {"device_kind": detect_device_kind(), "peaks": "unknown",
                "config_error": str(exc)}
    kind = detect_device_kind()
    peaks = cfg.resolve_peaks(kind)
    return {
        "device_kind": kind,
        "peaks": peaks.as_dict() if peaks else "unknown",
    }


def resolve_peaks(environ=None) -> PeakSpec | None:
    """Peaks only (the gauge refresh); None on a malformed knob too."""
    try:
        return roofline_config(environ).resolve_peaks(detect_device_kind())
    except ValueError:
        return None


# -- counting one execution ---------------------------------------------------

_local = threading.local()


def kernel_work(flops: float, nbytes: float) -> None:
    """Called by a hand-written kernel's wrapper at every call: adds its
    FLOPs and bytes to the capture running on this thread, if any. A
    wrapper passes its formula's FLOPs when it launches the kernel and 0
    when it runs the plain version (whose torch ops the counter counts),
    and its formula's bytes either way."""
    capture = getattr(_local, "capture", None)
    if capture is not None:
        capture.kernel_flops += float(flops)
        capture.kernel_bytes += float(nbytes)


def _tensor_bytes(t) -> int:
    return t.numel() * t.element_size()


class CostCapture:
    """Counts the work of the code run inside it, on this thread::

        with CostCapture(backend) as cap:
            outputs = backend(staged)
        cost = cap.result(io_bytes)

    ``result`` is ``{"available": True, "flops", "bytes_accessed",
    "transcendentals", "kernel_flops", "kernel_bytes"}`` or
    ``{"available": False, "reason"}`` (capture disabled, or the counter
    could not start); it never raises. ``transcendentals`` is 0: the
    counter does not count them."""

    def __init__(self, module=None, config: RooflineConfig | None = None):
        self.module = module
        self.config = config
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self._counter = None
        self._modes: list = []
        self._reason = None
        # storage pointer -> bytes of each parameter and buffer
        self._params: dict[int, int] = {}
        self._gathered: set[int] = set()
        self._gather_bytes = 0

    def __enter__(self) -> "CostCapture":
        cfg = self.config
        if cfg is None:
            try:
                cfg = roofline_config()
            except ValueError:
                cfg = RooflineConfig()
        if not cfg.capture:
            self._reason = f"disabled by {ENV_VAR}"
            return self
        try:
            from torch.utils.flop_counter import FlopCounterMode

            if self.module is not None:
                for t in list(self.module.parameters()) \
                        + list(self.module.buffers()):
                    storage = t.untyped_storage()
                    self._params[storage.data_ptr()] = storage.nbytes()
            self._counter = FlopCounterMode(display=False)
            for mode in (self._counter, _GatherMode(self)):
                mode.__enter__()
                self._modes.append(mode)
        except Exception as exc:  # noqa: BLE001 — degrade, never fail
            self._close()
            self._reason = f"{type(exc).__name__}: {exc}"[:200]
            return self
        _local.capture = self
        return self

    def __exit__(self, *exc_info) -> None:
        if getattr(_local, "capture", None) is self:
            _local.capture = None
        self._close()

    def _close(self) -> None:
        while self._modes:
            self._modes.pop().__exit__(None, None, None)

    def note_gather(self, src, out) -> None:
        """A gather read rows of ``src``: when ``src`` is a parameter or
        buffer, it counts the rows gathered (``out``'s bytes), not its
        whole size."""
        ptr = src.untyped_storage().data_ptr()
        if ptr in self._params:
            self._gathered.add(ptr)
            self._gather_bytes += _tensor_bytes(out)

    def result(self, io_bytes: int = 0) -> dict:
        if self._reason is not None:
            return {"available": False, "reason": self._reason}
        params = sum(n for ptr, n in self._params.items()
                     if ptr not in self._gathered)
        return {
            "available": True,
            "flops": float(self._counter.get_total_flops())
            + self.kernel_flops,
            "bytes_accessed": float(params + self._gather_bytes
                                    + self.kernel_bytes + io_bytes),
            "transcendentals": 0.0,
            "kernel_flops": self.kernel_flops,
            "kernel_bytes": self.kernel_bytes,
        }


def _gather_ops():
    import torch

    aten = torch.ops.aten
    return (aten.embedding.default, aten.index_select.default,
            aten.index.Tensor, aten._embedding_bag.default)


def _GatherMode(capture: CostCapture):
    """A dispatch mode that shows ``capture`` each gather's source and
    result (built on first use: the module is imported without torch)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    gathers = _gather_ops()

    class GatherMode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in gathers and args:
                capture.note_gather(
                    args[0], out[0] if isinstance(out, tuple) else out)
            return out

    return GatherMode()


# -- the join -----------------------------------------------------------------


def classify_bound(intensity: float | None,
                   peaks: PeakSpec | None) -> str:
    """``compute`` | ``bandwidth`` | ``unknown``: arithmetic intensity
    against the device ridge point. Unknown when either side is."""
    if intensity is None or peaks is None:
        return "unknown"
    ridge = peaks.ridge()
    if ridge is None:
        return "unknown"
    return "bandwidth" if intensity < ridge else "compute"


def bucket_roofline(cost: dict | None, calls: int, device_s: float,
                    padded_fraction: float = 0.0,
                    peaks: PeakSpec | None = None) -> dict:
    """Join one bucket's counted cost with its measured warm-call device
    seconds. ``calls`` must be the *warm* execution count: ``device_s``
    excludes the cold first execution, so the rates divide like with
    like. A bucket without a cost returns the annotated absence, with
    ``bound: unknown``."""
    if not cost or not cost.get("available"):
        return {
            "cost_model": "unavailable",
            "reason": (cost or {}).get("reason", "not captured"),
            "bound": "unknown",
        }
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes_accessed", 0.0))
    calls = max(0, int(calls))
    intensity = (flops / byts) if byts > 0 else None
    out = {
        "cost_model": "counted",
        "flops_per_call": flops,
        "bytes_per_call": byts,
        "arithmetic_intensity": round(intensity, 4)
        if intensity is not None else None,
        "total_flops": flops * calls,
        "total_bytes": byts * calls,
        # The count prices the padded bucket, so the padded row fraction
        # of its FLOPs was spent multiplying zeros.
        "padding_wasted_flops": flops * calls * max(
            0.0, min(1.0, padded_fraction)),
        "achieved_flops_per_s": None,
        "achieved_bytes_per_s": None,
        "mfu": None,
        "mbu": None,
        "bound": classify_bound(intensity, peaks),
    }
    if device_s > 0 and calls > 0:
        achieved_f = flops * calls / device_s
        achieved_b = byts * calls / device_s
        out["achieved_flops_per_s"] = achieved_f
        out["achieved_bytes_per_s"] = achieved_b
        if peaks and peaks.flops_per_s:
            out["mfu"] = round(achieved_f / peaks.flops_per_s, 6)
        if peaks and peaks.bytes_per_s:
            out["mbu"] = round(achieved_b / peaks.bytes_per_s, 6)
    return out


# -- shared analytic denominators --------------------------------------------


def bert_flops_per_example(seq_len=128, hidden=768, n_layers=12, ffn=3072):
    """Analytic forward FLOPs for one BERT-base example (2*MAC convention):
    per layer 4 QKVO projections + 2 attention einsums + 2 FFN matmuls.
    The analytic check of the counted FLOPs of a BERT bucket."""
    s, h, f = seq_len, hidden, ffn
    per_layer = 8 * s * h * h + 4 * s * s * h + 4 * s * h * f
    return n_layers * per_layer
