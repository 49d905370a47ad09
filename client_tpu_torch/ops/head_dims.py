"""The head dims an attention kernel takes, shared by its wrappers."""

from __future__ import annotations

import bisect


def kernel_head_dim(d: int, instantiations: tuple[int, ...],
                    kernel: str) -> int:
    """The instantiation that runs head dim ``d``: the smallest of
    ``instantiations`` (ascending) that holds it. ValueError naming
    ``kernel`` and its range for a ``d`` outside 1 to the largest."""
    if not 1 <= d <= instantiations[-1]:
        raise ValueError(f"the {kernel} takes head dims 1 to "
                         f"{instantiations[-1]}, got {d}")
    return instantiations[bisect.bisect_left(instantiations, d)]
