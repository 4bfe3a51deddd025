"""Which device a run executes on — the port's counterpart of
``deequ_tpu/parallel/mesh.py:use_mesh`` for one card.

Resolution: an explicit ``device=`` argument > the ambient
:func:`use_device` scope > ``cuda``. A run resolved to ``cuda`` in a
process that sees no CUDA device raises
:class:`~deequ_tpu_torch.exceptions.DeviceUnavailableException`: the
port never falls back to the host quietly. The CPU is a device a caller
asks for by name (the tests do, and so may a user without a card).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Union

import torch

from deequ_tpu_torch.exceptions import DeviceUnavailableException

DeviceLike = Union[str, torch.device, None]

_ACTIVE_DEVICE: contextvars.ContextVar = contextvars.ContextVar(
    "deequ_tpu_torch_device", default=None
)


@contextlib.contextmanager
def use_device(device: DeviceLike):
    """Run every entry point inside the block on ``device``
    (``"cpu"``, ``"cuda"``, ``"cuda:1"``, or a ``torch.device``)."""
    token = _ACTIVE_DEVICE.set(torch.device(device) if device is not None else None)
    try:
        yield
    finally:
        _ACTIVE_DEVICE.reset(token)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device a run executes on (module doc). Raises
    DeviceUnavailableException for a CUDA device this process cannot use."""
    if device is None:
        device = _ACTIVE_DEVICE.get()
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailableException(
                "deequ_tpu_torch runs on a CUDA device unless asked for the "
                "CPU, and torch.cuda.is_available() is False; pass "
                "device='cpu' or wrap the call in use_device('cpu')"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise DeviceUnavailableException(
                f"{dev} requested but only {torch.cuda.device_count()} CUDA "
                f"device(s) are visible"
            )
    elif dev.type != "cpu":
        raise DeviceUnavailableException(
            f"deequ_tpu_torch runs on 'cuda' or 'cpu', not {dev.type!r}"
        )
    return dev

