"""A tiny Try/Success/Failure result type.

The reference stores every metric value as ``Try[T]`` (metrics/Metric.scala:30)
so that partial failure is first-class data. This module is the Python
equivalent used throughout deequ_tpu_torch.
"""

from __future__ import annotations

from typing import Callable, Generic, TypeVar

T = TypeVar("T")
U = TypeVar("U")


class Try(Generic[T]):
    """Either a Success carrying a value or a Failure carrying an exception."""

    is_success: bool = False

    @staticmethod
    def of(fn: Callable[[], T]) -> "Try[T]":
        try:
            return Success(fn())
        except Exception as e:  # noqa: BLE001 — failure is data here
            return Failure(e)

    def get(self) -> T:
        raise NotImplementedError

    def get_or_else(self, default):
        return self.get() if self.is_success else default

    def map(self, fn: Callable[[T], U]) -> "Try[U]":
        raise NotImplementedError

    @property
    def is_failure(self) -> bool:
        return not self.is_success


class Success(Try[T]):
    is_success = True

    __slots__ = ("value",)

    def __init__(self, value: T):
        self.value = value

    def get(self) -> T:
        return self.value

    def map(self, fn: Callable[[T], U]) -> Try[U]:
        return Try.of(lambda: fn(self.value))

    def __repr__(self) -> str:
        return f"Success({self.value!r})"

    def __eq__(self, other) -> bool:
        return isinstance(other, Success) and self.value == other.value

    def __hash__(self) -> int:
        return hash(("Success", self.value))


class Failure(Try[T]):
    is_success = False

    __slots__ = ("exception",)

    def __init__(self, exception: BaseException):
        self.exception = exception

    def get(self) -> T:
        raise self.exception

    def map(self, fn) -> Try:
        return self

    def __repr__(self) -> str:
        return f"Failure({self.exception!r})"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Failure)
            and type(self.exception) is type(other.exception)
            and str(self.exception) == str(other.exception)
        )

    def __hash__(self) -> int:
        return hash(("Failure", type(self.exception), str(self.exception)))
