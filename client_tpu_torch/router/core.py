"""Router core: the port's copy of ``rendezvous_pick`` from
``client_tpu/router/core.py``, which the HTTP client's multi-URL mode uses
to pin a sequence to one target. The router itself is not ported yet."""

from __future__ import annotations

import hashlib


def rendezvous_pick(ids, token) -> str:
    """Highest-random-weight (rendezvous) hash: every client that knows
    the same id set picks the same replica for ``token``, and removing a
    replica only remaps the tokens that lived on it."""
    return max(ids, key=lambda i: hashlib.blake2b(
        f"{i}|{token}".encode(), digest_size=8).digest())
