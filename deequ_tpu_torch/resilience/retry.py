"""RetryPolicy — exponential backoff, jitter and a deadline for transient
I/O; the port's subset of ``deequ_tpu/resilience/retry.py``:
``RetryPolicy``, ``retry_call``, ``RetryingFileSystem`` (a FileSystem
proxy whose every operation runs under the policy — the state providers'
storage), and the batch reads of a stream (``resilient_batches``,
``RetryingBatchSource``). The reference's process default policy,
``RetryTelemetry``, its run-budget charge and the quarantine of
unreadable batches come with the resilient stream loop (slice 8c).

Jitter draws from a policy-owned ``random.Random(seed)``, so identical
failure sequences sleep identical schedules.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from random import Random
from typing import Callable, Iterator, List, Optional, Tuple

from deequ_tpu_torch.exceptions import RetryExhaustedException

# errors worth retrying by default: the OS and network layer, not logic
DEFAULT_RETRY_ON = (OSError, TimeoutError)


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with full jitter and an optional wall deadline.

    The delay after failed attempt k (0-based) is
    ``min(base_delay * multiplier**k, max_delay)`` scaled by a jitter draw
    in ``[1 - jitter, 1]``; the whole operation must finish within
    ``deadline`` seconds of its first attempt (None = no deadline)."""

    max_attempts: int = 4
    base_delay: float = 0.05
    max_delay: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.1
    deadline: Optional[float] = None
    retry_on: Tuple[type, ...] = DEFAULT_RETRY_ON
    seed: int = 0
    _rng: Random = field(init=False, repr=False, compare=False, hash=False)

    def __post_init__(self):
        object.__setattr__(self, "_rng", Random(self.seed))

    def delay_for(self, attempt: int) -> float:
        raw = min(self.base_delay * (self.multiplier ** attempt), self.max_delay)
        if self.jitter:
            raw *= 1.0 - self.jitter * self._rng.random()
        return raw

    def is_retryable(self, exc: BaseException) -> bool:
        return isinstance(exc, self.retry_on)

    def call(self, fn: Callable, *args, what: str = "operation", **kwargs):
        """Run ``fn`` under the policy; RetryExhaustedException when the
        attempt budget or the deadline runs out."""
        start = time.monotonic()
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — filtered below
                if not self.is_retryable(e):
                    raise
                attempt += 1
                out_of_time = (
                    self.deadline is not None
                    and time.monotonic() - start >= self.deadline
                )
                if attempt >= self.max_attempts or out_of_time:
                    raise RetryExhaustedException(what, attempt, e) from e
                time.sleep(self.delay_for(attempt - 1))


# the storage layer's default: quick, bounded, and free on healthy storage
DEFAULT_IO_RETRY = RetryPolicy(max_attempts=3, base_delay=0.02, max_delay=0.5)


def retry_call(fn: Callable, policy: Optional[RetryPolicy] = None,
               what: str = "operation"):
    """``fn()`` under ``policy`` (DEFAULT_IO_RETRY when None)."""
    return (policy or DEFAULT_IO_RETRY).call(fn, what=what)


class RetryingFileSystem:
    """FileSystem proxy running every operation under a RetryPolicy.

    ``open`` retries the open itself; an error raised by the returned
    handle mid-read or mid-write propagates (the caller's unit of retry is
    the whole read or write, as in ``atomic_write_bytes``)."""

    def __init__(self, inner, policy: Optional[RetryPolicy] = None):
        self.inner = inner
        self.policy = policy

    def _call(self, name: str, *args, **kwargs):
        return retry_call(
            lambda: getattr(self.inner, name)(*args, **kwargs),
            self.policy,
            what=f"filesystem {name}",
        )

    def open(self, path: str, mode: str = "rb"):
        return self._call("open", path, mode)

    def exists(self, path: str) -> bool:
        return self._call("exists", path)

    def makedirs(self, path: str) -> None:
        self._call("makedirs", path)

    def listdir(self, path: str) -> List[str]:
        return self._call("listdir", path)

    def delete(self, path: str) -> None:
        self._call("delete", path)

    def rename(self, src: str, dst: str) -> None:
        self._call("rename", src, dst)

    def join(self, *parts: str) -> str:
        return self.inner.join(*parts)


# -- batch reads of a stream --------------------------------------------------


def resilient_batches(
    make_iter: Callable[[int], Iterator],
    policy: Optional[RetryPolicy],
    start: int = 0,
) -> Iterator:
    """The batches of ``make_iter``, each read under ``policy``.

    ``make_iter(i)`` returns a fresh iterator positioned at batch index
    ``i`` (``BatchSource.batches_from``): batch boundaries are fixed for a
    fixed ``batch_rows``. On a retryable error the iterator reopens at the
    failing index after a backoff, so a retried read yields the same
    batches, in the same order, as a clean one; when the attempts or the
    deadline run out, RetryExhaustedException. Any other error propagates
    at once. (The reference's quarantine of unreadable batches is the
    resilient stream loop's, slice 8c.)"""
    cur = start
    attempts = 0
    t0 = time.monotonic()
    while True:
        it = make_iter(cur)
        try:
            for batch in it:
                yield batch
                cur += 1
                attempts = 0
                t0 = time.monotonic()
            return
        except Exception as e:  # noqa: BLE001 — filtered below, re-raised
            # an inner retry layer already spent its attempts on this
            # batch: do not multiply them
            if (isinstance(e, RetryExhaustedException) or policy is None
                    or not policy.is_retryable(e)):
                raise
            attempts += 1
            out_of_budget = attempts >= policy.max_attempts or (
                policy.deadline is not None and time.monotonic() - t0 >= policy.deadline
            )
            if out_of_budget:
                raise RetryExhaustedException(f"batch {cur} read", attempts, e) from e
            time.sleep(policy.delay_for(attempts - 1))


class RetryingBatchSource:
    """A BatchSource whose every batch read runs under a RetryPolicy
    (reopen and fast-forward on a transient error). It plugs in wherever a
    source does — the fused streaming scan, the grouping folds, the
    profiler — because the retrying happens inside ``batches``."""

    def __init__(self, inner, policy: Optional[RetryPolicy] = None):
        self.inner = inner
        self.policy = policy if policy is not None else DEFAULT_IO_RETRY

    @property
    def schema(self):
        return self.inner.schema

    @property
    def num_rows(self):
        return self.inner.num_rows

    @property
    def _batch_rows(self):
        return getattr(self.inner, "_batch_rows", None)

    def batches(self, columns=None, batch_rows=None):
        yield from self.batches_from(0, columns=columns, batch_rows=batch_rows)

    def _inner_from(self, start, columns, batch_rows):
        if hasattr(self.inner, "batches_from"):
            return self.inner.batches_from(start, columns=columns, batch_rows=batch_rows)
        from deequ_tpu_torch.data.source import BatchSource

        return BatchSource.batches_from(self.inner, start, columns=columns,
                                        batch_rows=batch_rows)

    def batches_from(self, start: int = 0, columns=None, batch_rows=None):
        yield from resilient_batches(
            lambda i: self._inner_from(i, columns, batch_rows), self.policy, start=start
        )
