"""Flash attention: a hand-written Hopper kernel and its plain version.

Counterpart of ``client_tpu/ops/flash_attention.py`` (the Pallas TPU kernel
``_fa_kernel``). The public layout is the serving models' ``[B, S, H, D]``;
masking is an additive ``[B, S]`` key bias (0 attend, -1e9 or -inf drop;
any float dtype, taken in fp32 as the reference casts it) plus an
optional causal flag. Scores at or below -1e30 get probability
exactly 0 and a row with nothing to attend to outputs 0, never NaN.

:func:`flash_attention` launches the CUDA kernel in
``client_tpu_torch/csrc/flash_attention.cu`` for tensors on the card and
takes :func:`flash_attention_plain` only for tensors on the CPU. The kernel
runs in bf16 (the BERTs), in fp16 (the bf16 kernel on f16 ``wgmma``; no
served model) and in fp32 (the generative models' prefill), at every head
dim from 1 to 256, as the Pallas kernel takes any: it is instantiated at
``KERNEL_HEAD_DIMS`` (32, 64, 128, 256; in bf16 and fp16
``TWO_BYTE_HEAD_DIMS``, which adds 96), and any other head dim runs the
next larger instantiation with the head dim zero-padded
(:func:`kernel_head_dim`, :func:`two_byte_head_dim`;
:func:`flash_attention_padded_plain` is that rule in plain PyTorch). It
raises above 256 and on anything else it does not take. In fp32 above head
dim 64 the kernel runs 3xTF32 on ``wgmma`` and reads K and V through a
pre-pass, :func:`split_kv`, launched first by the same call: K's and V's
TF32 halves, once a call, into scratch the wrapper allocates (V transposed,
its keys permuted; :func:`split_kv_plain` is its plain version).
``launches`` counts bf16 launches, ``launches_fp32`` fp32 ones and
``launches_split`` the pre-pass's and ``launches_fp16`` fp16 ones, so a run
can show that its path went through the kernels; ``launches_by_head_dim``,
``launches_fp32_by_head_dim`` and ``launches_fp16_by_head_dim`` count them
by the head dim requested, and ``launches_causal_by_dtype_head_dim`` the
causal ones by (dtype, head dim). Each call reports its work (:func:`work`,
at the real head dim) to a roofline capture running on its thread: the
``ctypes`` launch is invisible to the FLOP counter.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from client_tpu_torch.observability import roofline
from client_tpu_torch.ops import cuda_build, head_dims
from client_tpu_torch.utils import lockdep

_NEG_INF = -1e30
KERNEL_HEAD_DIMS = (32, 64, 128, 256)  # the kernel's instantiations
TWO_BYTE_HEAD_DIMS = (32, 64, 96, 128, 256)  # bf16's and fp16's

launches = 0
launches_fp32 = 0
launches_split = 0                                 # the fp32 pre-pass
launches_fp16 = 0
launches_by_head_dim = collections.Counter()       # bf16, by requested D
launches_fp32_by_head_dim = collections.Counter()  # fp32, by requested D
launches_fp16_by_head_dim = collections.Counter()  # fp16, by requested D
# Causal launches in every dtype, by (dtype, requested D).
launches_causal_by_dtype_head_dim = collections.Counter()
_count_lock = lockdep.Lock("ops.flash_attention.count")
_fwd = None
_split = None
_bind_lock = lockdep.Lock("ops.flash_attention.bind")


# The instantiation that runs head dim ``d`` (zero-padded to it); ValueError
# outside 1 to 256. In fp32 ``kernel_head_dim``, in bf16 and fp16
# ``two_byte_head_dim`` (which also has 96).
kernel_head_dim = functools.partial(head_dims.kernel_head_dim,
                                    instantiations=KERNEL_HEAD_DIMS,
                                    kernel="flash attention kernel")
two_byte_head_dim = functools.partial(head_dims.kernel_head_dim,
                                      instantiations=TWO_BYTE_HEAD_DIMS,
                                      kernel="flash attention kernel")


def pad_head_dim(x: torch.Tensor, width: int) -> torch.Tensor:
    """A contiguous copy of ``x`` with its last dim zero-padded to
    ``width``."""
    out = x.new_zeros((*x.shape[:-1], width))
    out[..., :x.shape[-1]] = x
    return out


# The pre-pass splits keys in groups of SPLIT_KEYS: its outputs hold the
# sequence padded to a multiple of it. Above SPLIT_HEAD_DIM (the fp32
# instantiations at 128 and 256) the fp32 kernel reads K and V through it.
SPLIT_KEYS = 32
SPLIT_HEAD_DIM = 64


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    nearest on the low 13 mantissa bits, ties away from zero (the low 13
    bits of the result are 0)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x`` as big + small, both TF32: x = big + small to about 2^-22
    relative."""
    big = tf32_round(x)
    return big, tf32_round(x - big)


def permuted_keys(n: int) -> torch.Tensor:
    """The key that each position of V^T's rows holds, for ``n`` keys (a
    multiple of 8): in each group of 8, positions t and t + 4 take keys 2t
    and 2t + 1, the order in which a thread of the kernel holds P."""
    pos = torch.arange(n)
    e = pos % 8
    return pos - e + torch.where(e < 4, 2 * e, 2 * (e - 4) + 1)


def split_kv_plain(k: torch.Tensor, v: torch.Tensor,
                   width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The pre-pass in plain PyTorch: fp32 ``[B, S, H, D]`` k and v into
    ``kh`` ``[2, B, H, S_pad, width]`` (K's big half, then its small half)
    and ``vt`` ``[2, B, H, width, S_pad]`` (V's, transposed, the keys of
    each 8-key group in :func:`permuted_keys` order), zero past D and past
    S; S_pad is S rounded up to SPLIT_KEYS."""
    b, s, h, d = k.shape
    s_pad = -(-s // SPLIT_KEYS) * SPLIT_KEYS
    kp = k.new_zeros((b, h, s_pad, width))
    vp = v.new_zeros((b, h, s_pad, width))
    kp[:, :, :s, :d] = k.transpose(1, 2)
    vp[:, :, :s, :d] = v.transpose(1, 2)
    vp = vp[:, :, permuted_keys(s_pad).to(v.device)].transpose(2, 3)
    return (torch.stack(tf32_split(kp)), torch.stack(tf32_split(vp)))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor | None = None,
                          causal: bool = False,
                          sm_scale: float | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 scores, the same
    -1e30 and empty-row guards, P rounded to v's dtype before P.V, and the
    output in q's dtype. Scores are scaled by ``sm_scale``, 1/sqrt(D) when
    None. Holds the whole ``[B, H, S, S]`` score tensor."""
    s = q.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * sm_scale
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


def flash_attention_padded_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 bias: torch.Tensor | None = None,
                                 causal: bool = False) -> torch.Tensor:
    """The kernel's padding rule in plain PyTorch: q/k/v zero-padded to
    the instantiation's head dim (:func:`kernel_head_dim` in fp32,
    :func:`two_byte_head_dim` in bf16 and fp16), scores scaled by 1/sqrt(D)
    of the real D, and only the first D output columns kept. The zeros add
    nothing to q.k, and the padded columns of the output (zeros of v) are
    dropped, so it equals :func:`flash_attention_plain`."""
    d = q.shape[-1]
    width = (kernel_head_dim(d) if q.dtype == torch.float32
             else two_byte_head_dim(d))
    out = flash_attention_plain(
        *(pad_head_dim(t, width) for t in (q, k, v)), bias, causal,
        sm_scale=1.0 / math.sqrt(d))
    return out[..., :d]


def work(q: torch.Tensor, bias: torch.Tensor | None,
         causal: bool) -> tuple[float, int]:
    """(FLOPs, bytes) of one call at the real head dim (not the padded
    one the kernel computes with): QK^T and PV at 2 FLOP per MAC over
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
                               (torch.float16,
                                "client_tpu_flash_attention_fwd_f16"),
                               (torch.float32,
                                "client_tpu_flash_attention_fwd_f32")):
                fn = getattr(lib, sym)
                # fp32 also takes the pre-pass's halves and their row length.
                split_args = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                              if dtype == torch.float32 else [])
                fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                               + [ctypes.c_int64] * 13
                               + [ctypes.c_float, ctypes.c_int] + split_args
                               + [ctypes.c_void_p])
                fn.restype = ctypes.c_int
                fns[dtype] = fn
            lib.client_tpu_cuda_error_string.argtypes = [ctypes.c_int]
            lib.client_tpu_cuda_error_string.restype = ctypes.c_char_p
            split = lib.client_tpu_split_kv_f32
            split.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                              + [ctypes.c_int64] * 6 + [ctypes.c_void_p])
            split.restype = ctypes.c_int
            _fwd = (fns, lib.client_tpu_cuda_error_string, split)
        return _fwd


def _direct(t: torch.Tensor) -> bool:
    """Whether the kernel reads ``[B, S, H, D]`` ``t`` as it lies: unit
    stride along D, and D, every other stride and the address multiples of
    16 bytes."""
    per_16_bytes = 16 // t.element_size()
    sb, ss, sh, sd = t.stride()
    return (sd == 1 and t.shape[3] % per_16_bytes == 0
            and sb % per_16_bytes == 0 and ss % per_16_bytes == 0
            and sh % per_16_bytes == 0 and t.data_ptr() % 16 == 0)


def check_kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      bias: torch.Tensor | None) -> None:
    """Raise ValueError for inputs the kernel does not take: anything but
    bf16, fp16 or fp32 ``[B, S, H, D]`` q/k/v of one shape, one dtype and
    one device (the reference promotes mixed dtypes; the kernel does not
    take them), D from 1 to 256, and an fp32 contiguous ``[B, S]`` bias
    (:func:`flash_attention` casts a bias of another float dtype first).
    Any layout is taken: :func:`flash_attention` pads a copy of q/k/v
    where the kernel cannot read them as they lie (:func:`_direct`)."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"q/k/v must share one [B, S, H, D] shape, got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    kernel_head_dim(q.shape[-1])
    if q.shape[0] > 65535 or q.shape[2] > 65535:
        raise ValueError(f"batch and heads map to grid dims of at most 65535, "
                         f"got {tuple(q.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"the flash attention kernel takes bfloat16, "
                         f"float16 or float32, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"q, k and v must share one dtype (the kernel "
                             f"does not promote mixed dtypes): {name} is "
                             f"{t.dtype}, q {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if bias is not None:
        if bias.shape != q.shape[:2] or bias.dtype != torch.float32 \
                or not bias.is_contiguous() or bias.device != q.device:
            raise ValueError(
                f"bias must be a contiguous float32 [B, S] tensor on "
                f"{q.device}, got {bias.dtype} {tuple(bias.shape)} on "
                f"{bias.device}")


def _launch_split(split, k: torch.Tensor, v: torch.Tensor, width: int,
                  stream: int) -> tuple[torch.Tensor, int, int]:
    """Allocate the pre-pass's outputs for ``[B, S, H, D]`` k and v in one
    buffer (``kh`` ``[2, B, H, S_pad, width]``, then ``vt`` ``[2, B, H,
    width, S_pad]``) and launch it. Returns the buffer, S_pad and the
    launch's error code."""
    b, s, h, d = k.shape
    s_pad = -(-s // SPLIT_KEYS) * SPLIT_KEYS
    n = 2 * b * h * s_pad * width
    buf = torch.empty(2 * n, device=k.device)
    err = split(k.data_ptr(), v.data_ptr(), buf.data_ptr(),
                buf.data_ptr() + 4 * n, b, s, h, d, width, s_pad,
                *k.stride()[:3], *v.stride()[:3], stream)
    return buf, s_pad, err


def split_kv(k: torch.Tensor, v: torch.Tensor,
             width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The fp32 kernel's pre-pass alone (:func:`split_kv_plain`'s
    function; :func:`flash_attention` launches it itself): launches its
    kernel for fp32 ``[B, S, H, D]`` k and v on the card that the kernel
    reads as they lie (:func:`_direct`), D <= ``width`` <= 256, ``width`` a
    multiple of 4, or raises; on the CPU it is the plain version."""
    if k.device.type == "cpu":
        return split_kv_plain(k, v, width)
    if k.dtype != torch.float32 or v.dtype != torch.float32 \
            or k.shape != v.shape or k.dim() != 4 \
            or not (_direct(k) and _direct(v)) or width % 4 \
            or not k.shape[3] <= width <= 256:
        raise ValueError(
            f"split_kv takes fp32 [B, S, H, D] k and v with 16-byte rows "
            f"and strides and D <= width <= 256 (width a multiple of 4), got "
            f"{k.dtype} {tuple(k.shape)}, {v.dtype} {tuple(v.shape)}, width "
            f"{width}")
    _, err_str, split = load_kernel()
    with torch.cuda.device(k.device):
        buf, s_pad, err = _launch_split(
            split, k, v, width,
            torch.cuda.current_stream(k.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"split_kv kernel launch failed: {err_str(err).decode()}")
    global launches_split
    with _count_lock:
        launches_split += 1
    b, _, h, _ = k.shape
    kh, vt = buf.view(2, 2, b, h, -1)
    return (kh.view(2, b, h, s_pad, width), vt.view(2, b, h, width, s_pad))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor | None = None,
                    causal: bool = False) -> torch.Tensor:
    """Attention over ``[B, S, H, D]`` q/k/v with an additive ``[B, S]``
    key bias of any float dtype; returns ``[B, S, H, D]`` in q's dtype. On
    the card this launches the Hopper kernel (in fp32 above head dim 64,
    the pre-pass first) or raises; on the CPU it is the plain version."""
    if q.device.type == "cpu":
        # The plain version's torch ops count their own FLOPs.
        roofline.kernel_work(0.0, work(q, bias, causal)[1])
        return flash_attention_plain(q, k, v, bias, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if bias is not None and bias.is_floating_point() and (
            bias.dtype != torch.float32 or not bias.is_contiguous()):
        # The kernel reads an fp32 bias, as the reference casts it.
        bias = bias.to(torch.float32, memory_format=torch.contiguous_format)
    check_kernel_args(q, k, v, bias)
    cost = work(q, bias, causal)
    d = q.shape[3]
    if not (_direct(q) and _direct(k) and _direct(v)):
        # The kernel's loads need 16-byte rows: one zero-padded copy of
        # q/k/v, D rounded up to 16 bytes (the kernel pads the rest of the
        # way to its instantiation itself, and stores only D columns).
        per_16_bytes = 16 // q.element_size()
        width = -(-d // per_16_bytes) * per_16_bytes
        q, k, v = (pad_head_dim(t, width) for t in (q, k, v))
    b, s, h, d_in = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fns, err_str, split = load_kernel()
    fwd = fns[q.dtype]
    # fp32 takes the pre-pass's halves (none at or below SPLIT_HEAD_DIM).
    halves = (None, None, 0) if q.dtype == torch.float32 else ()
    global launches, launches_fp32, launches_split, launches_fp16
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if q.dtype == torch.float32 and \
                kernel_head_dim(d_in) > SPLIT_HEAD_DIM:
            # The pre-pass first, on the same stream.
            buf, s_pad, err = _launch_split(split, k, v,
                                            kernel_head_dim(d_in), stream)
            if err != 0:
                raise RuntimeError(f"split_kv kernel launch failed: "
                                   f"{err_str(err).decode()}")
            with _count_lock:
                launches_split += 1
            kh_bytes = buf.numel() // 2 * 4  # vt follows kh
            halves = (buf.data_ptr(), buf.data_ptr() + kh_bytes, s_pad)
        err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  bias.data_ptr() if bias is not None else None,
                  out.data_ptr(), b, s, h, d_in, d,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  *out.stride()[:3],
                  bias.stride(0) if bias is not None else 0,
                  1.0 / math.sqrt(d), int(causal), *halves, stream)
    if err != 0:
        raise RuntimeError(
            f"flash attention kernel launch failed: {err_str(err).decode()}")
    roofline.kernel_work(*cost)
    with _count_lock:
        if q.dtype == torch.float32:
            launches_fp32 += 1
            launches_fp32_by_head_dim[d] += 1
        elif q.dtype == torch.float16:
            launches_fp16 += 1
            launches_fp16_by_head_dim[d] += 1
        else:
            launches += 1
            launches_by_head_dim[d] += 1
        if causal:
            launches_causal_by_dtype_head_dim[q.dtype, d] += 1
    return out
