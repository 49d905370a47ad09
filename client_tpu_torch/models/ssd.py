"""SSD-MobileNet-v2 COCO detector (`ssd_mobilenet_v2_coco_quantized`,
and the batched `ssd_mobilenet_v2_tpu`) as one ``nn.Module``.

Counterpart of ``client_tpu/models/ssd.py``: UINT8 NHWC [300,300,3] input
named ``normalized_input_image_tensor``, dequantized in bf16 as
``(x - 127.5) / 127.5``; four FP32 outputs ``TFLite_Detection_PostProcess
[:1|:2|:3]`` with per-sample dims [1,10,4] boxes, [1,10] classes, [1,10]
scores and [1] count. Three parts:

- the MobileNetV2 inverted-residual backbone (bf16, depthwise 3x3 as a
  grouped convolution), tapped at 19x19 on block 13's expansion and at
  10x10 on its output;
- four extra layers down to 1x1 and six 3x3 box/class heads, whose NCHW
  outputs are permuted to NHWC before they are flattened, so anchors run
  in (y, x, anchor) order as in JAX;
- static anchors (1,917 over six scales) and :func:`decode_and_nms`, the
  box decode and a class-agnostic greedy NMS of 10 steps over ``[B, N]``
  tensors, in place of ``jax.vmap`` over ``lax.fori_loop``.

Padding follows XLA's ``"SAME"`` (:func:`client_tpu_torch.models.vision.
same_pad`). Weights are random from the port's own seed unless the JAX
package's are carried across with ``load_jax_params``.
"""

from __future__ import annotations

import numpy as np
import torch

from client_tpu_torch.engine.config import (
    DynamicBatchingConfig,
    ModelConfig,
    TensorConfig,
)
from client_tpu_torch.models import register_model
from client_tpu_torch.models.vision import _TreeBackend, bn, conv

NUM_CLASSES = 91          # COCO label map (91 ids incl. background gaps)
MAX_DETECTIONS = 10
IOU_THRESHOLD = 0.5
SCORE_THRESHOLD = 0.05

# MobileNetV2 inverted-residual spec: (expansion, out_channels, n, stride)
_MBV2_SPEC = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)

# SSD feature-map sizes for a 300x300 input and anchors per cell.
_FEATURE_MAPS = ((19, 3), (10, 6), (5, 6), (3, 6), (2, 6), (1, 6))
_SCALES = (0.2, 0.35, 0.5, 0.65, 0.8, 0.95)
_TAP_BLOCK = 13  # 19x19 tap: expansion of the first 160-channel block


def _mbv2_blocks() -> list[tuple[int, int, int, int, bool]]:
    """Per-block (cin, cout, expansion, stride, residual) of
    ``_MBV2_SPEC``."""
    out = []
    cin = 32
    for expansion, cout, n, stride in _MBV2_SPEC:
        for i in range(n):
            out.append((cin, cout, expansion, stride if i == 0 else 1,
                        (i > 0 or stride == 1) and cin == cout))
            cin = cout
    return out


def make_anchors() -> np.ndarray:
    """Static [N,4] anchor boxes (cy, cx, h, w) in normalized coords."""
    all_anchors = []
    for (fm, n_anchors), scale in zip(_FEATURE_MAPS, _SCALES):
        ratios = (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0, 1.0)[:n_anchors]
        for y in range(fm):
            for x in range(fm):
                cy, cx = (y + 0.5) / fm, (x + 0.5) / fm
                for i, r in enumerate(ratios):
                    s = scale * (1.25 if (i == n_anchors - 1 and n_anchors > 1)
                                 else 1.0)
                    all_anchors.append(
                        [cy, cx, s / np.sqrt(r), s * np.sqrt(r)])
    return np.asarray(all_anchors, np.float32)


def decode_and_nms(boxes_enc: torch.Tensor, scores_all: torch.Tensor,
                   anchors: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """Box decode and greedy class-agnostic NMS for a batch.

    ``boxes_enc`` [B,N,4] and ``scores_all`` [B,N,C] fp32, ``anchors``
    [N,4]. Returns boxes [B,10,4], classes [B,10] (the argmax over columns
    1..C-1, as a float), scores [B,10] and count [B]. Each of the 10 steps
    picks the first index of the highest remaining score; it is kept when
    its score is > 0 (scores under ``SCORE_THRESHOLD`` start at 0); a
    kept pick zeroes every candidate whose IoU with it is > 0.5, and the
    pick is zeroed whether kept or not. The IoU denominator is clamped at
    1e-9. Every decision matches ``client_tpu/models/ssd.py``."""
    a = anchors
    cy = a[:, 0] + 0.1 * boxes_enc[..., 0] * a[:, 2]
    cx = a[:, 1] + 0.1 * boxes_enc[..., 1] * a[:, 3]
    h = a[:, 2] * torch.exp(0.2 * boxes_enc[..., 2])
    w = a[:, 3] * torch.exp(0.2 * boxes_enc[..., 3])
    ymin, xmin = cy - h / 2, cx - w / 2
    ymax, xmax = cy + h / 2, cx + w / 2
    boxes = torch.stack([ymin, xmin, ymax, xmax], dim=-1)      # [B,N,4]

    cls_scores = scores_all[..., 1:]  # drop background column 0
    best_cls = torch.argmax(cls_scores, dim=-1).float()
    best_score = torch.amax(cls_scores, dim=-1)
    scores = torch.where(best_score >= SCORE_THRESHOLD, best_score, 0.0)
    area = (torch.clamp(ymax - ymin, min=0)
            * torch.clamp(xmax - xmin, min=0))                  # [B,N]

    b = boxes_enc.shape[0]
    rows = torch.arange(b, device=boxes_enc.device)
    out_boxes, out_cls, out_scores = [], [], []
    for _ in range(MAX_DETECTIONS):
        j = torch.argmax(scores, dim=1)                         # [B]
        s = scores[rows, j]
        box = boxes[rows, j]                                    # [B,4]
        keep = s > 0.0
        out_boxes.append(torch.where(keep[:, None], box, 0.0))
        out_cls.append(torch.where(keep, best_cls[rows, j], 0.0))
        out_scores.append(torch.where(keep, s, 0.0))
        iy1 = torch.maximum(ymin, box[:, 0:1])
        ix1 = torch.maximum(xmin, box[:, 1:2])
        iy2 = torch.minimum(ymax, box[:, 2:3])
        ix2 = torch.minimum(xmax, box[:, 3:4])
        inter = torch.clamp(iy2 - iy1, min=0) * torch.clamp(ix2 - ix1, min=0)
        box_area = (torch.clamp(box[:, 2] - box[:, 0], min=0)
                    * torch.clamp(box[:, 3] - box[:, 1], min=0))
        iou = inter / torch.clamp(area + box_area[:, None] - inter, min=1e-9)
        scores = torch.where((iou > IOU_THRESHOLD) & keep[:, None], 0.0,
                             scores)
        scores = scores.index_put((rows, j), torch.zeros_like(s))
    out_s = torch.stack(out_scores, dim=1)
    count = (out_s > 0).float().sum(dim=1)
    return (torch.stack(out_boxes, dim=1), torch.stack(out_cls, dim=1),
            out_s, count)


def _relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


class SsdMobileNetV2Backend(_TreeBackend):
    def __init__(self, name: str = "ssd_mobilenet_v2_coco_quantized",
                 max_batch_size: int = 1, image_size: int = 300,
                 device: str | torch.device | None = None):
        super().__init__()
        batched = max_batch_size > 1
        self.config = ModelConfig(
            name=name,
            max_batch_size=max_batch_size,
            input=[TensorConfig("normalized_input_image_tensor", "UINT8",
                                [image_size, image_size, 3])],
            output=[
                TensorConfig("TFLite_Detection_PostProcess", "FP32",
                             [1, MAX_DETECTIONS, 4]),
                TensorConfig("TFLite_Detection_PostProcess:1", "FP32",
                             [1, MAX_DETECTIONS]),
                TensorConfig("TFLite_Detection_PostProcess:2", "FP32",
                             [1, MAX_DETECTIONS]),
                TensorConfig("TFLite_Detection_PostProcess:3", "FP32", [1]),
            ],
            dynamic_batching=DynamicBatchingConfig(
                preferred_batch_size=[max_batch_size],
                max_queue_delay_microseconds=300) if batched else None,
            instance_count=2,
        )
        self._statics = [(stride, residual) for _cin, _cout, _exp, stride,
                         residual in _mbv2_blocks()]
        init = self._init(300)
        tree = {"stem": {"w": init.conv(3, 3, 3, 32), "bn": init.bn(32)},
                "blocks": [], "heads": [], "extras": []}
        for cin, cout, expansion, _stride, _residual in _mbv2_blocks():
            mid = cin * expansion
            blk = {"bn1": init.bn(mid),
                   "wd": init.conv(3, 3, 1, mid),  # depthwise HWI(1)O
                   "bn2": init.bn(mid),
                   "wp": init.conv(1, 1, mid, cout),
                   "bn3": init.bn(cout)}
            if expansion != 1:
                blk["we"] = init.conv(1, 1, cin, mid)
            tree["blocks"].append(blk)
        cin = _mbv2_blocks()[-1][1]
        for _ in range(len(_FEATURE_MAPS) - 2):
            tree["extras"].append({"w1": init.conv(1, 1, cin, 128),
                                   "bn1": init.bn(128),
                                   "w2": init.conv(3, 3, 128, 256),
                                   "bn2": init.bn(256)})
            cin = 256
        head_cins = [576, 320] + [256] * (len(_FEATURE_MAPS) - 2)
        for (_fm, n_anchors), hc in zip(_FEATURE_MAPS, head_cins):
            tree["heads"].append({
                "box": init.conv(3, 3, hc, n_anchors * 4),
                "cls": init.conv(3, 3, hc, n_anchors * NUM_CLASSES)})
        self.register_buffer("anchors", torch.from_numpy(make_anchors()),
                             persistent=False)
        self._finish_init(tree, device)

    def _features(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = []
        y = _relu6(bn(conv(x, self.stem.w, stride=2), self.stem.bn))
        for bi, (blk, (stride, residual)) in enumerate(
                zip(self.blocks, self._statics)):
            inp = y
            expanded = (_relu6(bn(conv(y, blk.we), blk.bn1))
                        if hasattr(blk, "we") else y)
            y = _relu6(bn(conv(expanded, blk.wd, stride=stride,
                               groups=expanded.shape[1]), blk.bn2))
            y = bn(conv(y, blk.wp), blk.bn3)
            if residual:
                y = y + inp
            if bi == _TAP_BLOCK and hasattr(blk, "we"):
                feats.append(expanded)
        feats.append(y)  # 10x10, 320 channels
        for ex in self.extras:
            y = _relu6(bn(conv(y, ex.w1), ex.bn1))
            y = _relu6(bn(conv(y, ex.w2, stride=2), ex.bn2))
            feats.append(y)
        return feats

    def head_outputs(self, img: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """UINT8 NHWC images -> (box encodings [B,N,4], class scores
        [B,N,91]) in fp32, before decode and NMS."""
        x = img.permute(0, 3, 1, 2).to(torch.bfloat16)
        x = ((x - 127.5) / 127.5).to(self.compute_dtype)
        b = x.shape[0]
        box_parts, cls_parts = [], []
        for feat, head in zip(self._features(x), self.heads):
            # NCHW -> NHWC before flattening: anchors in (y, x, a) order.
            raw_box = conv(feat, head.box).float().permute(0, 2, 3, 1)
            raw_cls = conv(feat, head.cls).float().permute(0, 2, 3, 1)
            box_parts.append(raw_box.reshape(b, -1, 4))
            cls_parts.append(raw_cls.reshape(b, -1, NUM_CLASSES))
        boxes_enc = torch.cat(box_parts, dim=1)
        scores_all = torch.sigmoid(torch.cat(cls_parts, dim=1))
        if boxes_enc.shape[1] != self.anchors.shape[0]:
            raise ValueError(f"{boxes_enc.shape[1]} box encodings for "
                             f"{self.anchors.shape[0]} anchors")
        return boxes_enc, scores_all

    def forward(self, inputs: dict[str, torch.Tensor]
                ) -> dict[str, torch.Tensor]:
        boxes_enc, scores_all = self.head_outputs(
            inputs["normalized_input_image_tensor"])
        out_b, out_c, out_s, count = decode_and_nms(boxes_enc, scores_all,
                                                    self.anchors)
        return {
            "TFLite_Detection_PostProcess": out_b[:, None],
            "TFLite_Detection_PostProcess:1": out_c[:, None],
            "TFLite_Detection_PostProcess:2": out_s[:, None],
            "TFLite_Detection_PostProcess:3": count[:, None],
        }


register_model("ssd_mobilenet_v2_coco_quantized")(
    lambda device: SsdMobileNetV2Backend(device=device))
register_model("ssd_mobilenet_v2_tpu")(
    lambda device: SsdMobileNetV2Backend(name="ssd_mobilenet_v2_tpu",
                                         max_batch_size=16, device=device))
