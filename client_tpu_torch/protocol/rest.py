"""HTTP/REST framing of the KServe v2 infer body.

The port's own copy of ``client_tpu/protocol/rest.py``. A body is a JSON
head; each tensor may carry a ``binary_data_size`` parameter and append its
raw bytes, in tensor order, after the head. The
``Inference-Header-Content-Length`` header gives the head's length.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from client_tpu_torch.protocol.codec import deserialize_tensor, serialize_tensor
from client_tpu_torch.protocol.dtypes import DataType, wire_to_np_dtype

HEADER_INFERENCE_CONTENT_LENGTH = "Inference-Header-Content-Length"


@dataclass
class WireTensor:
    """One input or output tensor as it appears on the wire."""

    name: str
    datatype: str | None = None
    shape: list[int] | None = None
    parameters: dict[str, Any] = field(default_factory=dict)
    data: list | None = None   # JSON-inline values
    raw: bytes | None = None   # binary-extension payload

    def to_numpy(self) -> np.ndarray:
        if self.datatype is None or self.shape is None:
            raise ValueError(f"tensor '{self.name}' needs datatype and shape")
        if self.raw is not None:
            return deserialize_tensor(self.raw, self.datatype, self.shape)
        if self.data is None:
            raise ValueError(f"tensor '{self.name}' carries no data")
        if self.datatype == DataType.BYTES:
            flat = [x.encode("utf-8") if isinstance(x, str) else bytes(x)
                    for x in _flatten(self.data)]
            return np.array(flat, dtype=np.object_).reshape(self.shape)
        np_dtype = wire_to_np_dtype(self.datatype)
        if np_dtype is None:
            raise ValueError(f"unknown datatype '{self.datatype}'")
        return np.array(self.data, dtype=np_dtype).reshape(self.shape)


def _flatten(lst) -> list:
    out = []
    stack = [lst]
    while stack:
        item = stack.pop()
        if isinstance(item, list):
            stack.extend(reversed(item))
        else:
            out.append(item)
    return out


def build_tensor_json(name: str, arr: np.ndarray, datatype: str, shape, *,
                      binary: bool) -> tuple[dict, bytes | None]:
    """The JSON entry and, for ``binary``, the raw payload of one tensor."""
    entry: dict[str, Any] = {"name": name, "datatype": datatype,
                             "shape": [int(d) for d in shape]}
    if binary:
        raw = serialize_tensor(arr, datatype)
        entry["parameters"] = {"binary_data_size": len(raw)}
        return entry, raw
    flat = np.ravel(arr, order="C")
    if datatype == DataType.BYTES:
        entry["data"] = [x.decode("utf-8", errors="replace")
                         if isinstance(x, (bytes, np.bytes_)) else str(x)
                         for x in flat]
    else:
        entry["data"] = flat.tolist()
    return entry, None


def build_infer_request_body(inputs: list[tuple[dict, bytes | None]],
                             outputs: list[dict] | None = None,
                             request_id: str = "",
                             parameters: dict | None = None
                             ) -> tuple[bytes, int]:
    """A request body and the length of its JSON head; when any input
    carries a binary payload the caller sends the head's length as the
    ``Inference-Header-Content-Length`` header."""
    head: dict[str, Any] = {}
    if request_id:
        head["id"] = request_id
    if parameters:
        head["parameters"] = parameters
    head["inputs"] = [entry for entry, _ in inputs]
    if outputs is not None:
        head["outputs"] = outputs
    json_bytes = json.dumps(head, separators=(",", ":")).encode("utf-8")
    tails = [raw for _, raw in inputs if raw is not None]
    return json_bytes + b"".join(tails), len(json_bytes)


def split_body(body: bytes, header_json_length: int | None) -> tuple[dict, bytes]:
    """Split a v2 body into (parsed JSON head, binary tail)."""
    if header_json_length is None:
        head_bytes, tail = body, b""
    else:
        if not 0 <= header_json_length <= len(body):
            raise ValueError(
                f"{HEADER_INFERENCE_CONTENT_LENGTH} {header_json_length} is "
                f"outside the {len(body)}-byte body")
        head_bytes = body[:header_json_length]
        tail = body[header_json_length:]
    head = json.loads(head_bytes.decode("utf-8"))
    if not isinstance(head, dict):
        raise ValueError("the request head must be a JSON object")
    return head, tail


def parse_tensors(head_list: list[dict], tail: bytes) -> list[WireTensor]:
    """Walk tensors in order, slicing binary payloads off the tail."""
    tensors: list[WireTensor] = []
    offset = 0
    for entry in head_list or []:
        t = WireTensor(name=entry["name"], datatype=entry.get("datatype"),
                       shape=entry.get("shape"),
                       parameters=entry.get("parameters") or {})
        size = t.parameters.get("binary_data_size")
        if size is not None:
            size = int(size)
            if size < 0 or offset + size > len(tail):
                raise ValueError(
                    f"binary payload for '{t.name}' ({size}B at {offset}) "
                    f"overruns body tail of {len(tail)}B")
            t.raw = tail[offset:offset + size]
            offset += size
        elif "data" in entry:
            t.data = entry["data"]
        tensors.append(t)
    return tensors


def build_infer_response_body(outputs: list[tuple[dict, bytes | None]],
                              model_name: str, model_version: str,
                              request_id: str = "") -> tuple[bytes, int]:
    """Response body and the length of its JSON head."""
    head: dict[str, Any] = {"model_name": model_name,
                            "model_version": str(model_version)}
    if request_id:
        head["id"] = request_id
    head["outputs"] = [entry for entry, _ in outputs]
    json_bytes = json.dumps(head, separators=(",", ":")).encode("utf-8")
    tails = [raw for _, raw in outputs if raw is not None]
    return json_bytes + b"".join(tails), len(json_bytes)
