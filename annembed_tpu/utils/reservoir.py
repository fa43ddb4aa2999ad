"""Reservoir sampling (Algorithm L).

Rebuilds reference src/tools/reservoir.rs:12 ``unweighted_reservoir``.
On an accelerator, sampling without replacement from an in-memory range is simply
``jax.random.choice``; this host-side generator version is kept for
streaming iterables (API parity with the reference, which uses it for
the Facco 2NN node sample, kgraph.rs:276).
"""

from __future__ import annotations

import math
import random
from typing import Iterable, List, TypeVar

T = TypeVar("T")


def unweighted_reservoir(sample_size: int, iterable: Iterable[T],
                         seed: int = 4664397) -> List[T]:
    """Uniform sample of ``sample_size`` items in one pass (Algorithm L:
    skip ahead geometrically instead of flipping a coin per item)."""
    rng = random.Random(seed)
    reservoir: List[T] = []
    it = iter(iterable)
    try:
        for _ in range(sample_size):
            reservoir.append(next(it))
    except StopIteration:
        return reservoir
    w = math.exp(math.log(rng.random()) / sample_size)
    i = sample_size
    while True:
        skip = math.floor(math.log(rng.random())
                          / math.log(1.0 - w)) + 1
        try:
            for _ in range(skip - 1):
                next(it)
            item = next(it)
        except StopIteration:
            return reservoir
        i += skip
        reservoir[rng.randrange(sample_size)] = item
        w *= math.exp(math.log(rng.random()) / sample_size)
