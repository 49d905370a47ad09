"""Decoupled-response coalescing shared by the stream frontends.

The port's own copy of ``client_tpu/server/coalesce.py``. Per-message
framing (protobuf and an HTTP/2 write on gRPC, JSON and a chunked write on
SSE) bounds the served token path once decode waves outrun the writer. A
request that opts in with the ``response_coalesce`` parameter lets a
frontend merge its *backlogged* non-final responses into one message whose
outputs are the rows concatenated along axis 0 (k ``[1]``-shaped
TOKEN/INDEX rows of a generation stream become one ``[k]`` tensor).

Per-request order is kept (a merge only joins consecutive rows of one
request), finals and errors never merge, and a dtype or trailing-shape
change starts a new message. Off backlog every response ships alone.
"""

from __future__ import annotations

import numpy as np

from client_tpu_torch.engine.types import InferRequest, InferResponse

# Per-flush merge bound shared by every stream writer: caps one message's
# concatenation memory and wire size even when the pending limit is raised.
COALESCE_MAX = 512


def mergeable(req: InferRequest, resp: InferResponse) -> bool:
    """May this response join a coalesce run at all?"""
    return (resp.error is None and not resp.final
            and bool(req.parameters.get("response_coalesce"))
            and all(getattr(a, "ndim", 0) >= 1
                    for a in resp.outputs.values()))


def run_compatible(prev: InferResponse, resp: InferResponse) -> bool:
    """Do consecutive responses concatenate cleanly (same names, dtypes and
    trailing dims; axis 0 is the merge axis)?"""
    if set(prev.outputs) != set(resp.outputs):
        return False
    return all(prev.outputs[n].dtype == a.dtype
               and prev.outputs[n].shape[1:] == a.shape[1:]
               for n, a in resp.outputs.items())


def drain_run(first: InferResponse, get_nowait, req: InferRequest,
              cap: int = COALESCE_MAX):
    """Single-request run builder (the SSE writer: one stream, one
    request): from ``first``, pull already-queued responses while they
    merge cleanly. ``get_nowait()`` returns the next queued response or
    None when the queue is empty. Returns ``(merged, leftover)``, where
    ``leftover`` is the first pulled response that did not merge (the
    caller emits it after ``merged``) or None.

    The gRPC stream writer builds its runs itself: it interleaves many
    requests on one RPC and threads error items and backlog accounting
    through the drain."""
    run = [first]
    while len(run) < cap and mergeable(req, run[-1]):
        nxt = get_nowait()
        if nxt is None:
            break
        if mergeable(req, nxt) and run_compatible(run[-1], nxt):
            run.append(nxt)
            continue
        return merge(run), nxt
    return merge(run), None


def merge(resps: list[InferResponse]) -> InferResponse:
    """One response for a run: every output concatenated along axis 0."""
    if len(resps) == 1:
        return resps[0]
    last = resps[-1]
    return InferResponse(
        model_name=last.model_name,
        model_version=last.model_version,
        request_id=last.request_id,
        outputs={name: np.concatenate([r.outputs[name] for r in resps],
                                      axis=0)
                 for name in last.outputs},
        parameters=last.parameters,
        final=False,
        times=last.times,
    )
