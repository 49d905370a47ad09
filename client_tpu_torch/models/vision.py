"""Image classifiers ResNet-50 (`resnet50`) and DenseNet-121
(`densenet_onnx`) as ``nn.Module``s.

Counterpart of ``client_tpu/models/vision.py``, with the same numerics:

- the FP32 NHWC input is cast to bf16 first; weights and activations are
  bf16;
- batch norm is folded into a bf16 ``x*scale + bias``;
- the global mean is taken in fp32, and the FC layer runs in fp32;
- convolutions and max-pools pad as XLA's ``"SAME"`` does, which puts the
  odd pixel after, not before (:func:`same_pad`); DenseNet's 2x2/2
  average pool is ``"VALID"``.

The wire's NHWC batch is permuted once to an NCHW view, which is
``channels_last`` in memory and costs no copy; conv weights are OIHW,
stored ``channels_last`` too, so cuDNN takes NHWC kernels throughout.
Parameters are kept in the JAX package's pytree layout (``stem.w``,
``stages.0.0.bn1.scale``, ``fc.w``, ...), so :func:`params_from_jax` only
turns HWIO kernels into OIHW. Weights are random from the port's own
seeds unless the JAX package's are carried across with
``load_jax_params``. The compute dtype follows the weights: ``.float()``
gives an fp32 route with the same bf16 input quantization.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from client_tpu_torch.engine.backend_init import resolve_device
from client_tpu_torch.engine.config import (
    DynamicBatchingConfig,
    ModelConfig,
    TensorConfig,
)
from client_tpu_torch.engine.model import ModelBackend
from client_tpu_torch.models import register_model


# -- XLA "SAME" padding ------------------------------------------------------

def same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial axis as (before, after):
    the output has ``ceil(size / stride)`` positions and the odd pixel of
    an odd total goes after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _same_pads(x: torch.Tensor, k: int, stride: int
               ) -> tuple[tuple[int, int], tuple[int, int]]:
    return (same_pad(x.shape[2], k, stride), same_pad(x.shape[3], k, stride))


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
         groups: int = 1) -> torch.Tensor:
    """``"SAME"`` convolution of an NCHW view with an OIHW kernel. A
    symmetric pad goes to the convolution itself; an asymmetric one is
    applied with ``F.pad`` first."""
    (ht, hb), (wl, wr) = _same_pads(x, w.shape[-1], stride)
    if ht == hb and wl == wr:
        return F.conv2d(x, w, stride=stride, padding=(ht, wl), groups=groups)
    return F.conv2d(F.pad(x, (wl, wr, ht, hb)), w, stride=stride,
                    groups=groups)


def max_pool(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """``"SAME"`` max-pool: padded with -inf, as ``reduce_window`` starts
    from -inf."""
    (ht, hb), (wl, wr) = _same_pads(x, k, stride)
    if ht or hb or wl or wr:
        x = F.pad(x, (wl, wr, ht, hb), value=-math.inf)
    return F.max_pool2d(x, k, stride)


def bn(x: torch.Tensor, p: nn.Module) -> torch.Tensor:
    """Inference batch norm folded to ``x*scale + bias`` per channel."""
    return x * p.scale[:, None, None] + p.bias[:, None, None]


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """Spatial mean in fp32: ``[B, C, H, W]`` -> ``[B, C]``."""
    return x.float().mean(dim=(2, 3))


def dense_fp32(x: torch.Tensor, fc: nn.Module) -> torch.Tensor:
    """The classifier layer in fp32 (``fc.w`` is ``[in, out]``, as JAX
    keeps it)."""
    return x @ fc.w.float() + fc.b


# -- parameters in the JAX pytree layout --------------------------------------

class _Init:
    """Random weights with the JAX package's distributions, drawn from a
    seeded ``torch.Generator``, in the JAX layout (HWIO kernels)."""

    def __init__(self, seed: int):
        self.gen = torch.Generator().manual_seed(seed)

    def conv(self, kh: int, kw: int, cin: int, cout: int) -> torch.Tensor:
        std = math.sqrt(2.0 / (kh * kw * cin))
        return (torch.randn(kh, kw, cin, cout, generator=self.gen)
                * std).to(torch.bfloat16)

    def dense(self, cin: int, cout: int) -> torch.Tensor:
        std = math.sqrt(1.0 / cin)
        return (torch.randn(cin, cout, generator=self.gen)
                * std).to(torch.bfloat16)

    def bn(self, c: int) -> dict:
        scale = 1.0 + 0.1 * torch.randn(c, generator=self.gen)
        return {"scale": scale.to(torch.bfloat16),
                "bias": torch.zeros(c, dtype=torch.bfloat16)}


def _to_torch_layout(leaf) -> torch.Tensor:
    """One JAX leaf (numpy, bf16 included, or a tensor) as a torch
    tensor; a 4-D HWIO kernel becomes OIHW in ``channels_last`` memory."""
    t = (leaf if isinstance(leaf, torch.Tensor)
         else torch.from_numpy(np.array(leaf, dtype=np.float32)))
    if t.ndim == 4:
        t = t.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return t


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """The JAX backend's params pytree (leaves as numpy arrays) as a
    ``state_dict`` of these modules: the same dotted paths, HWIO kernels
    as OIHW (a depthwise ``[3,3,1,C]`` becomes ``[C,1,3,3]``)."""
    out: dict[str, torch.Tensor] = {}

    def walk(prefix: str, node) -> None:
        items = (node.items() if isinstance(node, dict)
                 else enumerate(node) if isinstance(node, (list, tuple))
                 else None)
        if items is None:
            out[prefix] = _to_torch_layout(node)
            return
        for k, v in items:
            walk(f"{prefix}.{k}" if prefix else str(k), v)

    walk("", tree)
    return out


def _add_tree(parent: nn.Module, tree: dict) -> None:
    """Attach a pytree of tensors to ``parent``: dicts become modules,
    lists ``ModuleList``s, leaves frozen parameters in the torch layout."""
    for key, node in tree.items():
        if isinstance(node, (dict, list, tuple)):
            parent.add_module(key, _tree_module(node))
        else:
            parent.register_parameter(
                key, nn.Parameter(_to_torch_layout(node), requires_grad=False))


def _tree_module(node) -> nn.Module:
    if isinstance(node, (list, tuple)):
        return nn.ModuleList(_tree_module(item) for item in node)
    mod = nn.Module()
    _add_tree(mod, node)
    return mod


class _TreeBackend(ModelBackend):
    """A backend whose parameters mirror the JAX package's pytree."""

    def _finish_init(self, tree: dict, device) -> None:
        _add_tree(self, tree)
        self.to(resolve_device(device))

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.stem.w.dtype

    def load_jax_params(self, tree) -> None:
        """Take the JAX backend's params (``make_apply_params()[1]``,
        leaves as numpy arrays) as this module's weights."""
        self.load_state_dict(params_from_jax(tree))

    def _input(self, inputs: dict[str, torch.Tensor]) -> torch.Tensor:
        """NHWC FP32 -> NCHW (channels_last) view, quantized to bf16, then
        in the compute dtype."""
        x = inputs["INPUT"].permute(0, 3, 1, 2).to(torch.bfloat16)
        return x.to(self.compute_dtype)


def _classifier_config(name: str, num_classes: int, image_size: int,
                       max_batch_size: int, instance_count: int
                       ) -> ModelConfig:
    return ModelConfig(
        name=name,
        max_batch_size=max_batch_size,
        input=[TensorConfig("INPUT", "FP32", [image_size, image_size, 3])],
        output=[TensorConfig("OUTPUT", "FP32", [num_classes])],
        dynamic_batching=DynamicBatchingConfig(
            preferred_batch_size=[max(1, max_batch_size // 2),
                                  max_batch_size],
            max_queue_delay_microseconds=500),
        instance_count=instance_count,
    )


# -- ResNet-50 ----------------------------------------------------------------

_RESNET50_STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))
_EXPANSION = 4


class ResNet50Backend(_TreeBackend):
    """ResNet-50 classifier: FP32 NHWC [224,224,3] -> FP32 [1000] logits."""

    def __init__(self, name: str = "resnet50", num_classes: int = 1000,
                 image_size: int = 224, stages=_RESNET50_STAGES,
                 max_batch_size: int = 32,
                 device: str | torch.device | None = None):
        super().__init__()
        self.config = _classifier_config(name, num_classes, image_size,
                                         max_batch_size, instance_count=2)
        init = _Init(50)
        tree = {"stem": {"w": init.conv(7, 7, 3, 64), "bn": init.bn(64)},
                "stages": []}
        cin = 64
        for n_blocks, width in stages:
            blocks = []
            for b in range(n_blocks):
                cout = width * _EXPANSION
                blk = {"w1": init.conv(1, 1, cin, width), "bn1": init.bn(width),
                       "w2": init.conv(3, 3, width, width),
                       "bn2": init.bn(width),
                       "w3": init.conv(1, 1, width, cout), "bn3": init.bn(cout)}
                if b == 0:
                    blk["wproj"] = init.conv(1, 1, cin, cout)
                    blk["bnproj"] = init.bn(cout)
                blocks.append(blk)
                cin = cout
            tree["stages"].append(blocks)
        tree["fc"] = {"w": init.dense(cin, num_classes),
                      "b": torch.zeros(num_classes)}
        self._finish_init(tree, device)

    @staticmethod
    def _bottleneck(x: torch.Tensor, blk: nn.Module,
                    stride: int) -> torch.Tensor:
        y = F.relu(bn(conv(x, blk.w1), blk.bn1))
        y = F.relu(bn(conv(y, blk.w2, stride=stride), blk.bn2))
        y = bn(conv(y, blk.w3), blk.bn3)
        if hasattr(blk, "wproj"):
            x = bn(conv(x, blk.wproj, stride=stride), blk.bnproj)
        return F.relu(x + y)

    def forward(self, inputs: dict[str, torch.Tensor]
                ) -> dict[str, torch.Tensor]:
        x = self._input(inputs)
        x = F.relu(bn(conv(x, self.stem.w, stride=2), self.stem.bn))
        x = max_pool(x, 3, 2)
        for si, blocks in enumerate(self.stages):
            for bi, blk in enumerate(blocks):
                x = self._bottleneck(x, blk, 2 if (si > 0 and bi == 0) else 1)
        return {"OUTPUT": dense_fp32(global_mean(x), self.fc)}


# -- DenseNet-121 ---------------------------------------------------------------

_DENSENET121_BLOCKS = (6, 12, 24, 16)


class DenseNet121Backend(_TreeBackend):
    """DenseNet-121 classifier (`densenet_onnx`): FP32 NHWC [224,224,3] ->
    FP32 [1000] logits."""

    def __init__(self, name: str = "densenet_onnx", num_classes: int = 1000,
                 image_size: int = 224, blocks=_DENSENET121_BLOCKS,
                 growth: int = 32, max_batch_size: int = 16,
                 device: str | torch.device | None = None):
        super().__init__()
        self.config = _classifier_config(name, num_classes, image_size,
                                         max_batch_size, instance_count=1)
        g = growth
        init = _Init(121)
        tree = {"stem": {"w": init.conv(7, 7, 3, 2 * g), "bn": init.bn(2 * g)},
                "blocks": [], "transitions": []}
        c = 2 * g
        for i, n_layers in enumerate(blocks):
            layers = []
            for _ in range(n_layers):
                layers.append({"bn1": init.bn(c),
                               "w1": init.conv(1, 1, c, 4 * g),
                               "bn2": init.bn(4 * g),
                               "w2": init.conv(3, 3, 4 * g, g)})
                c += g
            tree["blocks"].append(layers)
            if i < len(blocks) - 1:
                tree["transitions"].append({"bn": init.bn(c),
                                            "w": init.conv(1, 1, c, c // 2)})
                c //= 2
        tree["final_bn"] = init.bn(c)
        tree["fc"] = {"w": init.dense(c, num_classes),
                      "b": torch.zeros(num_classes)}
        self._finish_init(tree, device)

    def forward(self, inputs: dict[str, torch.Tensor]
                ) -> dict[str, torch.Tensor]:
        x = self._input(inputs)
        x = F.relu(bn(conv(x, self.stem.w, stride=2), self.stem.bn))
        x = max_pool(x, 3, 2)
        for i, layers in enumerate(self.blocks):
            for lyr in layers:
                y = conv(F.relu(bn(x, lyr.bn1)), lyr.w1)
                y = conv(F.relu(bn(y, lyr.bn2)), lyr.w2)
                x = torch.cat([x, y], dim=1)
            if i < len(self.blocks) - 1:
                tr = self.transitions[i]
                x = F.avg_pool2d(conv(F.relu(bn(x, tr.bn)), tr.w), 2)
        x = F.relu(bn(x, self.final_bn))
        return {"OUTPUT": dense_fp32(global_mean(x), self.fc)}


register_model("resnet50")(lambda device: ResNet50Backend(device=device))
register_model("densenet_onnx")(
    lambda device: DenseNet121Backend(device=device))
