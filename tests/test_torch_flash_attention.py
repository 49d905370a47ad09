"""The port's flash attention against the JAX package's.

The same numpy inputs, made from a seed, go through the Pallas kernel (in
interpret mode, as the JAX package's own tests run it on the CPU), its
``reference_attention`` and the port's ``flash_attention_plain``. The
Hopper kernel itself runs only on the card: ``tests/test_torch_cuda.py``
holds it against the plain version there.

Tolerances: 1e-5 in fp32 (the same math in another summation order);
2e-2 for bf16 inputs, where both round P to bf16 before P.V under a max
that the Pallas kernel takes per key block.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.ops.flash_attention import flash_attention as jax_flash
from client_tpu.ops.flash_attention import reference_attention
from client_tpu_torch.ops import flash_attention as fa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _qkv(b, s, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def _bias(kind, b, s):
    if kind == "none":
        return None
    bias = np.zeros((b, s), np.float32)
    if kind == "tail":  # BERT's padding mask: -1e9 past each row's length
        for i in range(b):
            bias[i, s - (i + 1) * s // 8:] = -1e9
    elif kind == "neg_inf":  # scattered keys dropped with -inf (not key 0,
        bias[:, 2::5] = -np.inf  # which a causal row 0 needs)
    elif kind == "fully_masked":  # row 1 has no key to attend to
        bias[0, s // 2:] = -1e9
        bias[1, :] = -np.inf
    return bias


def _jax(q, k, v, bias, causal, dtype=jnp.float32):
    args = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
    out = jax_flash(*args, None if bias is None else jnp.asarray(bias),
                    causal=causal, block_q=32, block_k=32, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _torch(q, k, v, bias, causal, dtype=torch.float32):
    args = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    out = fa.flash_attention_plain(
        *args, None if bias is None else torch.from_numpy(bias),
        causal=causal)
    return out.float().numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["none", "tail", "neg_inf", "fully_masked"])
def test_plain_matches_pallas_kernel_fp32(kind, causal):
    q, k, v = _qkv(2, 64, 4, 64)
    bias = _bias(kind, 2, 64)
    want = _jax(q, k, v, bias, causal)
    got = _torch(q, k, v, bias, causal)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["none", "tail", "neg_inf"])
def test_plain_matches_reference_attention_fp32(kind, causal):
    q, k, v = _qkv(2, 64, 4, 32, seed=1)
    bias = _bias(kind, 2, 64)
    want = np.asarray(reference_attention(
        *[jnp.asarray(x) for x in (q, k, v)],
        None if bias is None else jnp.asarray(bias), causal=causal))
    np.testing.assert_allclose(_torch(q, k, v, bias, causal), want,
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_pallas_kernel_bf16(causal):
    q, k, v = _qkv(2, 128, 4, 64, seed=2)
    bias = _bias("tail", 2, 128)
    want = _jax(q, k, v, bias, causal, dtype=jnp.bfloat16)
    got = _torch(q, k, v, bias, causal, dtype=torch.bfloat16)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


def test_ragged_sequence_length():
    """An S that no power-of-two block divides: the port takes no block
    sizes, and the Pallas kernel runs it as one block."""
    q, k, v = _qkv(3, 40, 2, 64, seed=3)
    bias = _bias("tail", 3, 40)
    want = np.asarray(jax_flash(*[jnp.asarray(x) for x in (q, k, v)],
                                jnp.asarray(bias), interpret=True))
    np.testing.assert_allclose(_torch(q, k, v, bias, False), want,
                               atol=1e-5, rtol=0)


def test_fully_masked_row_is_exactly_zero():
    q, k, v = _qkv(2, 64, 4, 64, seed=4)
    out = _torch(q, k, v, _bias("fully_masked", 2, 64), causal=False)
    assert (out[1] == 0).all()
    assert np.isfinite(out).all()


def test_cpu_tensor_takes_plain_version_and_launches_nothing():
    q, k, v = [torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv(2, 64, 4, 64, seed=5)]
    bias = torch.from_numpy(_bias("tail", 2, 64))
    before = fa.launches
    out = fa.flash_attention(q, k, v, bias)
    assert fa.launches == before
    assert torch.equal(out, fa.flash_attention_plain(q, k, v, bias))
    assert out.dtype == torch.bfloat16 and out.shape == q.shape


def test_other_devices_raise():
    q = torch.empty(1, 64, 1, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(q, q, q)


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("case", [
    "head_dim_32", "float32", "shape_mismatch", "bias_float16",
    "bias_shape", "d_stride",
])
def test_kernel_argument_checks(case):
    """What the kernel wrapper refuses before a launch (checked on CPU
    tensors: the checks read only shapes, dtypes and strides)."""
    q = k = v = _bf16(2, 64, 4, 64)
    bias = torch.zeros(2, 64)
    if case == "head_dim_32":
        q = k = v = _bf16(2, 64, 4, 32)
    elif case == "float32":
        q = torch.zeros(2, 64, 4, 64)
    elif case == "shape_mismatch":
        k = _bf16(2, 32, 4, 64)
    elif case == "bias_float16":
        bias = bias.half()
    elif case == "bias_shape":
        bias = torch.zeros(2, 63)
    elif case == "d_stride":
        q = _bf16(2, 64, 64, 4).transpose(2, 3)
    with pytest.raises(ValueError):
        fa.check_kernel_args(q, k, v, bias)


def test_kernel_argument_checks_accept_fused_qkv_slices():
    """BERT's q/k/v are strided slices of one [b, s, 3, h, 64] tensor;
    the kernel reads them through their strides, without a copy."""
    fused = _bf16(2, 64, 3, 4, 64)
    fa.check_kernel_args(fused[:, :, 0], fused[:, :, 1], fused[:, :, 2],
                         torch.zeros(2, 64))
    fa.check_kernel_args(fused[:, :, 0], fused[:, :, 1], fused[:, :, 2], None)


def test_import_needs_neither_nvcc_nor_a_gpu():
    """Importing the kernel modules builds and loads nothing."""
    code = (
        "import sys\n"
        "import client_tpu_torch.ops.flash_attention as fa\n"
        "import client_tpu_torch.models.bert\n"
        "assert fa._fwd is None and fa.launches == 0\n"
        "assert 'triton' not in sys.modules\n"
    )
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
