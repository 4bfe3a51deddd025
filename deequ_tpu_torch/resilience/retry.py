"""RetryPolicy — exponential backoff, jitter and a deadline for transient
I/O; the port of ``deequ_tpu/resilience/retry.py``:
``RetryPolicy``, ``retry_call`` (one-shot I/O: filesystem and spill-run
opens), the process default policy (``default_retry_policy``,
``set_default_retry_policy``, ``resolve_retry_policy``),
``RetryingFileSystem`` (a FileSystem proxy whose every operation runs
under the policy — the state providers' storage), and the batch reads of
a stream (``resilient_batches`` with the quarantine of unreadable batches
the resilient stream loop uses, ``RetryingBatchSource``), and
``RetryTelemetry``: every failed try is counted (``RETRY_TELEMETRY``,
reported per run as ``VerificationResult.retry_stats``) and charged to the
ambient run budget (``resilience/governance.py``), whose wall deadline
also caps each backoff sleep.

Jitter draws from a policy-owned ``random.Random(seed)``, so identical
failure sequences sleep identical schedules.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from random import Random
from typing import Callable, Iterator, List, Optional, Tuple

from deequ_tpu_torch.exceptions import RetryExhaustedException

class RetryTelemetry:
    """Process-wide retry accounting: every RetryPolicy invocation records
    its failed tries, its backoff sleep and the last exception seen;
    ``VerificationSuite`` reports the delta of a run as
    ``VerificationResult.retry_stats``.

    One meaning across both producers (``RetryPolicy.call`` and
    ``resilient_batches``): ``invocations`` retried-operation contexts
    entered; ``attempts`` FAILED tries (a clean first try is not one);
    ``retries`` failed tries followed by a backoff sleep; ``exhausted``
    operations abandoned past the attempt or deadline budget."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.invocations = 0
        self.attempts = 0
        self.retries = 0
        self.backoff_seconds = 0.0
        self.exhausted = 0
        self.last_exception: Optional[str] = None

    def record_attempt(self) -> None:
        self.attempts += 1
        # the flight recorder's I/O seam: a failed try is an instant event
        # (a clean first try never reaches here)
        from deequ_tpu_torch.obs.recorder import current_recorder

        rec = current_recorder()
        if rec is not None:
            rec.event("io_retry", attempts=self.attempts)

    def record_retry(self, slept: float, exc: BaseException) -> None:
        self.retries += 1
        self.backoff_seconds += slept
        self.last_exception = f"{type(exc).__name__}: {exc}"

    def record_exhausted(self, exc: BaseException) -> None:
        self.exhausted += 1
        self.last_exception = f"{type(exc).__name__}: {exc}"
        from deequ_tpu_torch.obs.recorder import current_recorder

        rec = current_recorder()
        if rec is not None:
            rec.event("io_retry_exhausted", error=self.last_exception)

    def snapshot(self) -> dict:
        return {
            "invocations": self.invocations,
            "attempts": self.attempts,
            "retries": self.retries,
            "backoff_seconds": self.backoff_seconds,
            "exhausted": self.exhausted,
            "last_exception": self.last_exception,
        }

    def delta_since(self, before: dict) -> dict:
        now = self.snapshot()
        out = {
            key: (round(now[key] - before[key], 6) if isinstance(now[key], float)
                  else now[key] - before[key])
            for key in now if key != "last_exception"
        }
        # the last exception means something only if a try failed since
        out["last_exception"] = (
            now["last_exception"] if (out["retries"] or out["exhausted"]) else None
        )
        return out


RETRY_TELEMETRY = RetryTelemetry()


def _backoff(policy: "RetryPolicy", failed: int, exc: BaseException) -> None:
    """Sleep the policy's delay after ``failed`` failed tries, never past
    the run budget's wall deadline (the next charge would exhaust it, but
    the sleep itself must not overshoot the promised deadline)."""
    from deequ_tpu_torch.resilience.governance import run_budget_remaining

    delay = policy.delay_for(failed - 1)
    wall_left = run_budget_remaining()
    if wall_left is not None:
        delay = min(delay, wall_left)
    RETRY_TELEMETRY.record_retry(delay, exc)
    time.sleep(delay)


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
        attempt budget or the deadline runs out. Every failed try is
        counted in RETRY_TELEMETRY and charged to the ambient run budget,
        which raises typed from here once it is exhausted."""
        from deequ_tpu_torch.resilience.governance import charge_run_budget

        start = time.monotonic()
        attempt = 0
        RETRY_TELEMETRY.invocations += 1
        while True:
            try:
                return fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — filtered below
                if not self.is_retryable(e):
                    raise
                attempt += 1
                RETRY_TELEMETRY.record_attempt()
                charge_run_budget("io_retry", what=what)
                out_of_time = (
                    self.deadline is not None
                    and time.monotonic() - start >= self.deadline
                )
                if attempt >= self.max_attempts or out_of_time:
                    RETRY_TELEMETRY.record_exhausted(e)
                    raise RetryExhaustedException(what, attempt, e) from e
                _backoff(self, attempt, e)


# the storage layer's default: quick, bounded, and free on healthy storage
DEFAULT_IO_RETRY = RetryPolicy(max_attempts=3, base_delay=0.02, max_delay=0.5)

# the process default (a deployment may turn retrying off, say under a
# fault-injection harness testing the unretried paths)
_default_policy: Optional[RetryPolicy] = DEFAULT_IO_RETRY


def default_retry_policy() -> Optional[RetryPolicy]:
    return _default_policy


def set_default_retry_policy(policy: Optional[RetryPolicy]) -> None:
    """Install the process-wide storage retry policy (None disables)."""
    global _default_policy
    _default_policy = policy


def retry_call(fn: Callable, policy: Optional[RetryPolicy] = None,
               what: str = "operation"):
    """``fn()`` under ``policy`` (or the process default; with no policy at
    all, one plain call)."""
    policy = policy if policy is not None else _default_policy
    if policy is None:
        return fn()
    return policy.call(fn, what=what)


def resolve_retry_policy(data=None, explicit: Optional[RetryPolicy] = None):
    """The policy of a stream's batch reads: the explicit argument, else
    the table's (``StreamingTable.with_retry``), else the process
    default."""
    if explicit is not None:
        return explicit
    attr = getattr(data, "retry_policy", None)
    if attr is not None:
        return attr
    return _default_policy


def _quarantinable(exc: BaseException) -> bool:
    """Errors that mean "this batch cannot be read or decoded", which
    ``on_batch_error="skip"`` may quarantine: I/O errors, typed corruption
    and the Arrow readers' decoding errors. Any other exception is a bug
    and propagates."""
    if isinstance(exc, DEFAULT_RETRY_ON):
        return True
    from deequ_tpu_torch.exceptions import CorruptStateException

    if isinstance(exc, CorruptStateException):
        return True
    try:  # decoding errors of the Arrow readers (torn or corrupt pages)
        import pyarrow as pa
    except ImportError:
        return False
    return isinstance(exc, pa.lib.ArrowException)


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
    on_batch_error: str = "fail",
    quarantined: Optional[List[int]] = None,
    start: int = 0,
    max_consecutive_skips: int = 16,
    max_batches: Optional[int] = None,
) -> Iterator[Tuple[int, object]]:
    """``(index, batch)`` of ``make_iter``, each read under ``policy``.

    ``make_iter(i)`` returns a fresh iterator positioned at batch index
    ``i`` (``BatchSource.batches_from``): batch boundaries are fixed for a
    fixed ``batch_rows``. On a retryable error the iterator reopens at the
    failing index after a backoff, so a retried read yields the same
    batches, in the same order, as a clean one. When the attempts or the
    deadline run out: ``on_batch_error="fail"`` raises
    RetryExhaustedException; ``"skip"`` records the index in
    ``quarantined`` and goes on at the next one — a poisoned batch costs
    its rows, not the run. An error the policy does not retry quarantines
    at once when it is quarantinable (``_quarantinable``), else it
    propagates; a RetryExhaustedException of an inner retry layer counts
    as exhausted here (its attempts are not multiplied).

    ``max_consecutive_skips`` bounds the optimism: a source that is dead
    fails every index, and skipping forever would never reach its end,
    so past that many quarantines in a row with no read between them the
    pass fails. ``max_batches`` (when the caller knows the batch count)
    tells an unreadable batch from an error of the end-of-stream probe:
    an error at an index past the last real batch ends the iteration.

    Every failed read is counted in RETRY_TELEMETRY and charged to the
    ambient run budget: a stream of N batches retries against ONE
    ``max_total_attempts``, not N budgets."""
    from deequ_tpu_torch.resilience.governance import charge_run_budget

    if on_batch_error not in ("fail", "skip"):
        raise ValueError(
            f"on_batch_error must be 'fail' or 'skip', got {on_batch_error!r}"
        )
    cur = start
    attempts = 0
    consecutive_skips = 0
    t0 = time.monotonic()
    RETRY_TELEMETRY.invocations += 1
    while True:
        it = make_iter(cur)
        try:
            for batch in it:
                yield cur, batch
                cur += 1
                attempts = 0
                consecutive_skips = 0
                t0 = time.monotonic()
            return
        except Exception as e:  # noqa: BLE001 — filtered below, re-raised
            if max_batches is not None and cur >= max_batches:
                return  # every real batch was read: the probe of the end failed
            exhausted = isinstance(e, RetryExhaustedException)
            retryable = not exhausted and policy is not None and policy.is_retryable(e)
            skippable = on_batch_error == "skip" and (exhausted or _quarantinable(e))
            if not retryable and not skippable:
                raise
            attempts += 1
            RETRY_TELEMETRY.record_attempt()
            charge_run_budget("io_retry", batch=cur)
            out_of_budget = exhausted or not retryable or attempts >= policy.max_attempts
            if policy is not None and policy.deadline is not None:
                out_of_budget = out_of_budget or time.monotonic() - t0 >= policy.deadline
            if not out_of_budget:
                _backoff(policy, attempts, e)
                continue
            if on_batch_error != "skip":
                RETRY_TELEMETRY.record_exhausted(e)
                raise RetryExhaustedException(f"batch {cur} read", attempts, e) from e
            consecutive_skips += 1
            if consecutive_skips > max_consecutive_skips:
                RETRY_TELEMETRY.record_exhausted(e)
                raise RetryExhaustedException(
                    f"{consecutive_skips} consecutive batches unreadable (through "
                    f"batch {cur}) — the source looks permanently dead, not "
                    f"patchily flaky",
                    attempts,
                    e,
                ) from e
            if quarantined is not None:
                quarantined.append(cur)
            cur += 1
            attempts = 0
            t0 = time.monotonic()


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
        for _idx, batch in resilient_batches(
            lambda i: self._inner_from(i, columns, batch_rows), self.policy, start=start
        ):
            yield batch
