"""Flash attention: a hand-written Hopper kernel and its plain version.

Counterpart of ``client_tpu/ops/flash_attention.py`` (the Pallas TPU kernel
``_fa_kernel``). The public layout is the serving models' ``[B, S, H, D]``;
masking is an additive fp32 ``[B, S]`` key bias (0 attend, -1e9 or -inf
drop) plus an optional causal flag. Scores at or below -1e30 get probability
exactly 0 and a row with nothing to attend to outputs 0, never NaN.

:func:`flash_attention` launches the CUDA kernel in
``client_tpu_torch/csrc/flash_attention.cu`` for tensors on the card and
takes :func:`flash_attention_plain` only for tensors on the CPU. The kernel
has a bf16 instantiation (the BERTs) and an fp32 one (the generative
models' prefill), both with head dim 64, and raises on anything else.
``launches`` counts bf16 launches and ``launches_fp32`` fp32 ones, so a
run can show that its path went through the kernel. Each call reports
its work (:func:`work`) to a roofline capture running on its thread:
the ``ctypes`` launch is invisible to the FLOP counter.
"""

from __future__ import annotations

import ctypes
import math

import torch

from client_tpu_torch.observability import roofline
from client_tpu_torch.ops import cuda_build
from client_tpu_torch.utils import lockdep

_NEG_INF = -1e30
_HEAD_DIM = 64  # the only head dim the kernel is built for

launches = 0
launches_fp32 = 0
_count_lock = lockdep.Lock("ops.flash_attention.count")
_fwd = None
_bind_lock = lockdep.Lock("ops.flash_attention.bind")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor | None = None,
                          causal: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 scores, the same
    -1e30 and empty-row guards, P rounded to v's dtype before P.V, and the
    output in q's dtype. Holds the whole ``[B, H, S, S]`` score tensor."""
    s = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * (1.0 / math.sqrt(q.shape[-1]))
    if bias is not None:
        scores = scores + bias[:, None, None, :].float()
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, _NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    safe_m = torch.where(m <= _NEG_INF, torch.zeros_like(m), m)
    p = torch.exp(scores.masked_fill(scores <= _NEG_INF, -math.inf) - safe_m)
    denom = p.sum(dim=-1, keepdim=True)
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return (out / denom.transpose(1, 2)).to(q.dtype)


def work(q: torch.Tensor, bias: torch.Tensor | None,
         causal: bool) -> tuple[float, int]:
    """(FLOPs, bytes) of one call: QK^T and PV at 2 FLOP per MAC over
    every (query, key) pair it attends (those on or below the diagonal
    when causal), and q, k, v read, the output written and the bias
    read once."""
    b, s, h, d = q.shape
    pairs = s * (s + 1) / 2 if causal else s * s
    nbytes = 4 * b * s * h * d * q.element_size()
    if bias is not None:
        nbytes += b * s * 4
    return 4.0 * b * h * d * pairs, nbytes


def load_kernel():
    """Build (on first use) and bind the kernel's C entry point."""
    global _fwd
    with _bind_lock:
        if _fwd is None:
            lib = cuda_build.load("flash_attention")
            fns = {}
            for dtype, sym in ((torch.bfloat16,
                                "client_tpu_flash_attention_fwd"),
                               (torch.float32,
                                "client_tpu_flash_attention_fwd_f32")):
                fn = getattr(lib, sym)
                fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                               + [ctypes.c_int64] * 13
                               + [ctypes.c_float, ctypes.c_int,
                                  ctypes.c_void_p])
                fn.restype = ctypes.c_int
                fns[dtype] = fn
            lib.client_tpu_cuda_error_string.argtypes = [ctypes.c_int]
            lib.client_tpu_cuda_error_string.restype = ctypes.c_char_p
            _fwd = (fns, lib.client_tpu_cuda_error_string)
        return _fwd


def check_kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      bias: torch.Tensor | None) -> None:
    """Raise ValueError for inputs the kernel does not take: anything but
    bf16 or fp32 ``[B, S, H, 64]`` q/k/v of one shape and one dtype with
    unit stride along D and 16-byte aligned rows, and an fp32 contiguous
    ``[B, S]`` bias."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"q/k/v must share one [B, S, H, D] shape, got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[-1] != _HEAD_DIM:
        raise ValueError(
            f"the kernel is built for head dim {_HEAD_DIM}, got {q.shape[-1]}")
    if q.shape[0] > 65535 or q.shape[2] > 65535:
        raise ValueError(f"batch and heads map to grid dims of at most 65535, "
                         f"got {tuple(q.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q must be bfloat16 or float32, got {q.dtype}")
    per_16_bytes = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(-1) != 1 \
                or any(st % per_16_bytes for st in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"{name} needs unit stride along D and 16-byte aligned rows, "
                f"got strides {t.stride()}")
    if bias is not None:
        if bias.shape != q.shape[:2] or bias.dtype != torch.float32 \
                or not bias.is_contiguous() or bias.device != q.device:
            raise ValueError(
                f"bias must be a contiguous float32 [B, S] tensor on "
                f"{q.device}, got {bias.dtype} {tuple(bias.shape)} on "
                f"{bias.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor | None = None,
                    causal: bool = False) -> torch.Tensor:
    """Attention over ``[B, S, H, D]`` q/k/v with an additive ``[B, S]``
    key bias; returns ``[B, S, H, D]`` in q's dtype. On the card this
    launches the Hopper kernel (or raises); on the CPU it is the plain
    version."""
    if q.device.type == "cpu":
        # The plain version's torch ops count their own FLOPs.
        roofline.kernel_work(0.0, work(q, bias, causal)[1])
        return flash_attention_plain(q, k, v, bias, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    check_kernel_args(q, k, v, bias)
    b, s, h, _ = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fns, err_str = load_kernel()
    fwd = fns[q.dtype]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  bias.data_ptr() if bias is not None else None,
                  out.data_ptr(), b, s, h,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  *out.stride()[:3],
                  bias.stride(0) if bias is not None else 0,
                  1.0 / math.sqrt(q.shape[-1]), int(causal), stream)
    if err != 0:
        raise RuntimeError(
            f"flash attention kernel launch failed: {err_str(err).decode()}")
    roofline.kernel_work(*work(q, bias, causal))
    global launches, launches_fp32
    with _count_lock:
        if q.dtype == torch.float32:
            launches_fp32 += 1
        else:
            launches += 1
    return out
