"""The row mesh of a sharded run — the port of ``deequ_tpu/parallel/mesh.py``.

deequ's distribution contract (SURVEY.md §2.15) is a partitioned scan, a
monoid state merge, group-by counts merged across partitions and a tree
reduce. The reference shards rows over a 1-D ``jax.sharding.Mesh`` axis
(``"rows"``) and merges with XLA collectives. The port drives the same
contract from one process over a :class:`Mesh` of members, each a
(member id, ``torch.device``) pair:

- each member scans its shard of every chunk on its own device with the
  port's kernels (``ops/scan_engine.py``), and its flat state vector is
  copied to the lead member (member 0, ``tensor.to(lead,
  non_blocking=True)``), where the members fold in member order through
  the tagged merge (K8: sum, min and max by ``k1_merge``, gather leaves
  concatenated member-major, as ``all_gather`` lays them out);
- grouping counts are counted on each member and summed exactly, in
  int64, on the lead (``ops/segment.py``).

Members: on a machine with several cards :func:`default_mesh` has one
member per visible CUDA device, the member id its ordinal.
:func:`virtual_mesh` puts ``n`` members on ONE device, with member ids
0..n-1 — the counterpart of the reference's
``--xla_force_host_platform_device_count``, so one card, or the CPU, runs
the sharded path. Only a caller asks for a virtual mesh (the tests,
``chip_smoke.py``); :func:`default_mesh` never returns one. A fault
message names a card by its ordinal, which on a virtual mesh is no member
id: such a mesh drives the sharded path, it does not model a card's loss.

Resolution (:func:`resolve_placement`), the rule every entry point
follows:

- the mesh a run asks for is an explicit ``mesh=`` argument, else the
  :func:`use_mesh` / :func:`set_mesh` scope; ``use_mesh(None)`` asks for
  no mesh;
- a mesh asked for runs on its members and is led by member 0's device.
  An explicit ``device=`` (or the ``use_device`` scope) that is not that
  device raises ``ValueError``: a mesh asked for never drops to one
  device without a sign;
- with no mesh asked for, an explicit device pins the run to that one
  device; with neither, the run takes :func:`default_mesh` where it has
  one, else the one device ``device.resolve_device`` gives (``cuda``).
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

ROW_AXIS = "rows"

_UNSET = object()

#: the mesh scope of this context: _UNSET, None (no mesh asked for) or a Mesh
_ACTIVE_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "deequ_tpu_torch_mesh", default=_UNSET
)


def _normal(device) -> torch.device:
    """``device`` as a torch.device with a CUDA ordinal filled in, so two
    spellings of one card compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class Mesh:
    """An ordered 1-D mesh of members along :data:`ROW_AXIS`: member ``i``
    scans the ``i``-th shard of every chunk. ``members`` holds (member id,
    device) pairs; ids are distinct, devices may repeat (a virtual mesh)."""

    members: Tuple[Tuple[int, torch.device], ...]

    def __post_init__(self):
        members = tuple((int(mid), _normal(dev)) for mid, dev in self.members)
        if not members:
            raise ValueError("a mesh needs at least one member")
        ids = [mid for mid, _ in members]
        if len(set(ids)) != len(ids):
            raise ValueError(f"mesh member ids must be distinct, got {ids}")
        object.__setattr__(self, "members", members)

    @property
    def size(self) -> int:
        return len(self.members)

    @property
    def device_ids(self) -> Tuple[int, ...]:
        return tuple(mid for mid, _ in self.members)

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(dev for _, dev in self.members)

    @property
    def lead(self) -> torch.device:
        """Member 0's device, where the members' states merge."""
        return self.members[0][1]


def default_mesh() -> Optional[Mesh]:
    """A mesh over every visible CUDA device, member id = ordinal (None
    when there are fewer than two)."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count <= 1:
        return None
    return Mesh([(i, torch.device("cuda", i)) for i in range(count)])


def virtual_mesh(n: int, device="cuda") -> Mesh:
    """``n`` members, ids 0..n-1, all on ``device`` (module doc)."""
    if n < 1:
        raise ValueError(f"a virtual mesh needs n >= 1, got {n}")
    from deequ_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    return Mesh([(i, dev) for i in range(n)])


def current_mesh() -> Optional[Mesh]:
    """The mesh of this context: the :func:`use_mesh` / :func:`set_mesh`
    scope, else :func:`default_mesh`."""
    scoped = _ACTIVE_MESH.get()
    return default_mesh() if scoped is _UNSET else scoped


def set_mesh(mesh: Optional[Mesh]) -> None:
    """Set this context's mesh scope (None: no mesh)."""
    _ACTIVE_MESH.set(mesh)


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Run every entry point inside the block over ``mesh`` (None: on one
    device, the default mesh set aside)."""
    token = _ACTIVE_MESH.set(mesh)
    try:
        yield
    finally:
        _ACTIVE_MESH.reset(token)


def mesh_size(mesh: Optional[Mesh]) -> int:
    return mesh.size if mesh is not None else 1


def mesh_device_ids(mesh: Optional[Mesh]) -> tuple:
    """The id of every member, in mesh order (empty for no mesh)."""
    return () if mesh is None else mesh.device_ids


def mesh_excluding(mesh: Mesh, lost_ids) -> Optional[Mesh]:
    """``mesh`` without the members whose ids are in ``lost_ids``, order
    kept; None when no member survives. A lone survivor is still a
    1-member mesh: the scan stays on the healthy member's device."""
    lost = {int(d) for d in lost_ids}
    survivors = [(mid, dev) for mid, dev in mesh.members if mid not in lost]
    return Mesh(survivors) if survivors else None


def resolve_placement(device=None, mesh=_UNSET) -> Tuple[torch.device, Optional[Mesh]]:
    """(the run's lead device, its mesh or None) by the rule of the module
    doc. Raises ValueError when an explicit device is not the lead of the
    mesh asked for, and DeviceUnavailableException for a CUDA device this
    process cannot use."""
    from deequ_tpu_torch.device import explicit_device, resolve_device

    asked = _ACTIVE_MESH.get() if mesh is _UNSET else mesh
    explicit = explicit_device(device)
    if asked is _UNSET:
        if explicit is None:
            asked = default_mesh()
        else:
            return resolve_device(explicit), None
    if asked is None:
        return resolve_device(explicit), None
    if not isinstance(asked, Mesh):
        raise TypeError(f"mesh must be a Mesh or None, got {type(asked).__name__}")
    if explicit is not None and resolve_device(explicit) != asked.lead:
        raise ValueError(
            f"device {explicit} was asked for, but the mesh {asked} is led by "
            f"{asked.lead}; pass that device, or use_mesh(None) for a run on one device"
        )
    for dev in set(asked.devices):
        resolve_device(dev)
    return asked.lead, asked


def scoped_mesh(device, mesh=_UNSET) -> Optional[Mesh]:
    """The mesh a call that was handed ``device`` runs over: an explicit
    ``mesh`` argument, else the :func:`use_mesh` scope — never the default
    mesh (the caller resolved its placement already). Raises ValueError
    when that mesh is not led by ``device``."""
    asked = _ACTIVE_MESH.get() if mesh is _UNSET else mesh
    if asked is _UNSET or asked is None:
        return None
    if _normal(device) != asked.lead:
        raise ValueError(
            f"the mesh {asked} is led by {asked.lead}, not by {torch.device(device)}"
        )
    return asked


def shard_bounds(start: int, stop: int, local_n: int, member: int) -> Tuple[int, int]:
    """[lo, hi) of member ``member``'s shard of rows [start, stop) at
    ``local_n`` rows a member (the reference's row sharding of a chunk
    padded to ``local_n`` times the mesh size): members past the chunk's
    last row hold none."""
    lo = min(start + member * local_n, stop)
    return lo, min(lo + local_n, stop)


def round_chunk(chunk: int, n: int) -> int:
    """``chunk`` rounded up to a multiple of ``n`` members (at least ``n``):
    every member's shard has one static width."""
    return max(n, -(-int(chunk) // n) * n)
