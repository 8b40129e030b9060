"""Shared retry/backoff policy for every layer that re-tries work.

The engine re-pools lost segments, :meth:`SectorClient.recover` re-resolves
stale metadata, and :class:`~repro_torch.sphere.streaming.TenantQueue` requeues
timed-out tickets — before this module each did so with zero-delay retries,
which hammers a recovering component exactly when it is least able to serve.
:class:`RetryPolicy` gives all three the same capped exponential backoff with
*seeded, deterministic* jitter: two processes configured with the same
``(seed, key, attempt)`` compute byte-identical delays, so chaos replays stay
reproducible and tests can assert exact schedules against a virtual clock.

The default policy is ``base=0.0`` — zero delay everywhere — so wiring a
policy through a call path is behaviour-preserving until a caller opts into
real backoff.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Tuple

__all__ = ["RetryPolicy"]


def _mix(*parts: int) -> int:
    """Deterministic integer mix (never ``hash()`` — PYTHONHASHSEED)."""
    acc = 0
    for p in parts:
        acc = (acc * 1000003 + int(p)) & 0xFFFFFFFFFFFFFFFF
    return acc


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with seeded deterministic jitter.

    ``delay(attempt, key)`` returns ``min(cap, base * factor**attempt)``
    scaled by a jitter factor drawn uniformly from
    ``[1 - jitter, 1 + jitter]`` with a :class:`random.Random` seeded from
    ``(seed, key, attempt)``. ``attempt`` counts from 0 (the delay before
    the first retry); ``key`` namespaces independent retry streams (a
    segment index, a ticket id, a crc of a path) so concurrent retriers do
    not thunder in lockstep.
    """

    base: float = 0.0       # seconds before the first retry (0 => no delay)
    factor: float = 2.0     # exponential growth per attempt
    cap: float = 30.0       # delay ceiling in seconds
    jitter: float = 0.0     # +/- fraction of the delay, in [0, 1)
    seed: int = 0

    def __post_init__(self) -> None:
        if self.base < 0 or self.factor < 1.0 or self.cap < 0:
            raise ValueError("base/cap must be >= 0 and factor >= 1")
        if not (0.0 <= self.jitter < 1.0):
            raise ValueError(f"jitter must be in [0, 1): {self.jitter}")

    def delay(self, attempt: int, key: int = 0) -> float:
        """Deterministic delay in seconds before retry number ``attempt``."""
        if attempt < 0:
            raise ValueError(f"attempt must be >= 0: {attempt}")
        d = min(self.cap, self.base * self.factor ** attempt)
        if d <= 0.0:
            return 0.0
        if self.jitter:
            rng = random.Random(_mix(self.seed, key, attempt))
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return d

    def schedule(self, attempts: int, key: int = 0) -> Tuple[float, ...]:
        """The full delay sequence for ``attempts`` retries (testing aid)."""
        return tuple(self.delay(a, key=key) for a in range(attempts))
