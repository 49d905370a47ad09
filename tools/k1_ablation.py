#!/usr/bin/env python3
"""Time K1's bf16/fp16 kernel with parts of its design switched off, in
turns with an older checkout's kernel, on the card.

    python3 tools/k1_ablation.py OLDER_CHECKOUT   # from the root of a checkout

The 2-byte flash kernel (``flash_fwd_kernel<Config, T>`` in
``client_tpu_torch/csrc/flash_attention.cu``) has these parts: each
consumer warpgroup stops at its own diagonal; K and V have rings of their
own; the grid is persistent; two consumers take turns on named barriers
(the ping-pong); P.V is one product over all head-dim columns; a causal
call of one round pairs heavy and light rows in each CTA; the warpgroup
index is warp-uniform for the compiler; a causal call without a bias reads
no bias. This script
writes copies of the source with the later parts switched off by text
patches (``VARIANTS``; a patch that no longer applies raises), builds them
and the older checkout's source with the port's nvcc flags (all at once),
and times every build at ``SHAPES`` by kernel durations from
``torch.profiler`` in turns (``chip_smoke._kernel_turns``), one process,
one card, with ``scaled_dot_product_attention`` in the same dtype (float
mask or ``is_causal``) in the same turns. Every variant must give the
older kernel's output bit for bit (the parts change no row's arithmetic).
Prints one JSON line of ms, of each build's time over the older one's and
of each over SDPA's, then ``nvidia-smi``'s name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "client_tpu_torch" / "csrc" / "flash_attention.cu"
OUT = ROOT / "build" / "k1_ablation"

# Patches, each (old text, new text), that switch a part off.
NO_PLAIN_SCORES = [(
    "  const bool plain_scores = causal && bias == nullptr;",
    "  const bool plain_scores = false;")]
NO_UNIFORM_WG = [(
    "  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);",
    "  const int wg = tid / 128;")]
NO_BALANCED = [(
    "  const bool balanced = causal && units <= static_cast<int>(gridDim.x);",
    "  const bool balanced = false;")]
NO_PERSISTENT = [(
    "  const int grid = static_cast<int>(units < sms ? units : sms);",
    "  const int grid = static_cast<int>(units);")]
NO_TURNS = [(
    "  static constexpr bool kTurns = Turns;",
    "  static constexpr bool kTurns = false;")]
# P.V as one product per column block (kBoxCols wide), not one over D.
NARROW_PV = [(
    """      const uint64_t desc_v =
          smem_desc<kRowBytes>(sm.v[stage][0], kBlockN * kRowBytes);
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        wgmma_rs<kHeadDim, kF16>(acc, pa[kk],
                                 desc_v + kk * (16 * kRowBytes >> 4));
      }""",
    """#pragma unroll
      for (int c = 0; c < kColBlocks; ++c) {
        const uint64_t desc_v = smem_desc<kRowBytes>(sm.v[stage][c]);
#pragma unroll
        for (int kk = 0; kk < kBlockN / 16; ++kk) {
          wgmma_rs<kBoxCols, kF16>(
              reinterpret_cast<float(&)[kBoxCols / 2]>(acc[c * kBoxCols / 2]),
              pa[kk], desc_v + kk * (16 * kRowBytes >> 4));
        }
      }""")]
SMALL_DIMS = ("typedef Config<32, 128, 4, 4, 3, 160, false> Config32;\n"
              "typedef Config<64, 128, 4, 4, 3, 160, true> Config64;")
# Head dims 32 and 64 on two ping-ponged consumers, or each on its other
# plan of three (32 taking turns, 64 independent).
TWO_PING_PONG = [(SMALL_DIMS,
                  SMALL_DIMS.replace("3, 160, false", "2, 240, true")
                  .replace("3, 160, true", "2, 240, true"))]
OTHER_THREE = [(SMALL_DIMS, SMALL_DIMS.replace("3, 160, false", "3, 160, x")
                .replace("3, 160, true", "3, 160, false")
                .replace("3, 160, x", "3, 160, true"))]
# One stage of K and V freed together after P.V, as one shared ring did:
# K's stage is freed with V's, and the rings are as deep as that ring was.
SHARED_RING = [
    ("        scale_bias(ks0);\n        mbar_arrive(&sm.k_empty[ks0]);\n",
     "        scale_bias(ks0);\n"),
    ("          scale_bias(ks);\n"
     "          mbar_arrive(&sm.k_empty[ks]);  // K and its bias are read\n",
     "          scale_bias(ks);\n"),
    ("          mbar_arrive(&sm.v_empty[vs]);\n"
     "          rescale_and_pack(corr);",
     "          mbar_arrive(&sm.v_empty[vs]);\n"
     "          mbar_arrive(&sm.k_empty[(k_it + j - 1) % kKStages]);\n"
     "          rescale_and_pack(corr);"),
    ("        mbar_arrive(&sm.v_empty[vs]);\n      } else {",
     "        mbar_arrive(&sm.v_empty[vs]);\n"
     "        mbar_arrive(&sm.k_empty[(k_it + my_tiles - 1) % kKStages]);\n"
     "      } else {"),
    ("typedef Config<96, 128, 4, 3, 2, 240, true> Config96;\n"
     "typedef Config<128, 128, 3, 2, 2, 240, true> Config128;\n"
     "typedef Config<256, 64, 3, 2, 2, 240, true> Config256;",
     "typedef Config<96, 128, 3, 3, 2, 240, true> Config96;\n"
     "typedef Config<128, 128, 2, 2, 2, 240, true> Config128;\n"
     "typedef Config<256, 64, 2, 2, 2, 240, true> Config256;"),
]

# Cumulative, each step one part more: own diagonals; + split rings; +
# persistent grid; + turns (the ping-pong from head dim 96, three in turn
# at 64); + P.V over all D columns at once; + balanced units (causal calls
# of one round); + the warpgroup index warp-uniform; + causal calls
# without a bias only scaling their scores (the checkout's kernel). And
# the checkout's with head dims 32 and 64 on two ping-ponged consumers, or
# each on its other plan of three.
LATER = {
    "diagonals": SHARED_RING + NO_PERSISTENT + NO_TURNS + NARROW_PV
    + NO_BALANCED + NO_UNIFORM_WG + NO_PLAIN_SCORES,
    "rings": NO_PERSISTENT + NO_TURNS + NARROW_PV + NO_BALANCED
    + NO_UNIFORM_WG + NO_PLAIN_SCORES,
    "persistent": NO_TURNS + NARROW_PV + NO_BALANCED + NO_UNIFORM_WG
    + NO_PLAIN_SCORES,
    "turns": NARROW_PV + NO_BALANCED + NO_UNIFORM_WG + NO_PLAIN_SCORES,
    "wide_pv": NO_BALANCED + NO_UNIFORM_WG + NO_PLAIN_SCORES,
    "balanced": NO_UNIFORM_WG + NO_PLAIN_SCORES,
    "uniform_wg": NO_PLAIN_SCORES,
    "plain_scores": [],
}
VARIANTS = {**LATER, "two_ping_pong": TWO_PING_PONG,
            "other_three": OTHER_THREE}

# (key, dtype, [B, S, H, D], causal): B8 S2048 H4 causal at 32, 64, 80,
# 128 and 256, the served prefill's shape, and bert_long's (tail-masked).
SHAPES = [("fp16_hd32_causal", "float16", (8, 2048, 4, 32), True),
          ("bf16_hd64_causal", "bfloat16", (8, 2048, 4, 64), True),
          ("fp16_hd64_causal", "float16", (8, 2048, 4, 64), True),
          ("fp16_hd80_causal", "float16", (8, 2048, 4, 80), True),
          ("fp16_hd128_causal", "float16", (8, 2048, 4, 128), True),
          ("fp16_hd256_causal", "float16", (8, 2048, 4, 256), True),
          ("fp16_hd128_prefill", "float16", (1, 1024, 16, 128), True),
          ("bf16_hd64_bert_long", "bfloat16", (4, 2048, 12, 64), False)]


def _patched(name: str, patches: list) -> Path:
    text = SRC.read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: a patch no longer applies:\n{old}")
        text = text.replace(old, new)
    path = OUT / f"{name}.cu"
    path.write_text(text)
    return path


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("k1_ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from client_tpu_torch.ops import cuda_build
    from client_tpu_torch.ops import flash_attention as fa

    older = Path(argv[0]).resolve()
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {name: _patched(name, patches)
               for name, patches in VARIANTS.items()}
    sources["older"] = older / "client_tpu_torch" / "csrc" / \
        "flash_attention.cu"
    procs = {name: subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
         str(OUT / f"{name}.so"), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, src in sources.items()}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")

    # Bind each library as the wrapper binds its own; a call swaps it in.
    class Build:
        path = None

        @classmethod
        def load(cls, _name):
            return ctypes.CDLL(str(cls.path))

    real_build, bound = fa.cuda_build, {}
    fa.cuda_build = Build
    for name in sources:
        Build.path = OUT / f"{name}.so"
        fa._fwd = None
        bound[name] = fa.load_kernel()
    fa.cuda_build, fa._fwd = real_build, None

    def call(name, q, k, v, bias, causal):
        fa._fwd = bound[name]
        return fa.flash_attention(q, k, v, bias, causal=causal)

    gen = torch.Generator(device="cuda").manual_seed(27)
    result = {}
    for key, dtype_name, shape, causal in SHAPES:
        dtype = getattr(torch, dtype_name)
        q, k, v = (torch.randn(shape, device="cuda", generator=gen)
                   .to(dtype) for _ in range(3))
        bias = None if causal else chip_smoke._hd_bias(
            torch, shape[0], shape[1], False)
        want = call("older", q, k, v, bias, causal)
        for name in VARIANTS:
            got = call(name, q, k, v, bias, causal)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{key}: {name} differs from the older "
                                     "kernel's output")
        calls = {name: (lambda name=name: call(name, q, k, v, bias, causal))
                 for name in ["older", *VARIANTS]}
        calls["sdpa"] = lambda: torch.nn.functional.\
            scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=(None if bias is None
                           else bias[:, None, None, :].to(dtype)),
                is_causal=causal)
        ms = chip_smoke._kernel_turns(torch, calls)
        result[key] = {"ms": ms, "over_older": {
            name: ms[name] / ms["older"] for name in VARIANTS}, "over_sdpa": {
            name: ms[name] / ms["sdpa"] for name in ["older", *VARIANTS]}}
        print(f"k1_ablation: {key} {json.dumps(result[key])}", flush=True)
        del q, k, v
    fa._fwd = None
    print(json.dumps(result), flush=True)
    print(chip_smoke._nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
