"""Multi-process runs and peer loss — the port of
``deequ_tpu/parallel/distributed.py`` on ``torch.distributed``.

Several processes (on one machine or several) split a table by row
ranges: each calls :func:`initialize_multi_host` once, ingests its
:func:`host_row_range` of the globally ordered rows, scans it on its own
device or mesh, and :func:`merge_process_states` exchanges the flat state
vectors as host tensors over the process group (gloo by default: NCCL
cannot pair two ranks on one card) and folds them in rank order with the
tagged monoid the scan engine uses across chunks and members — sum, min,
max, and gather leaves concatenated rank-major. The merged states give
the metrics a one-process run of the whole table gives (sums and moments
within ``docs/numerics.md``'s bounds). The reference runs this exchange in
``__graft_entry__.py:dryrun_multihost`` with a cross-process
``all_gather``; its ``jax.process_index`` / ``process_count`` are the
group's rank and world size here (:func:`process_index`,
:func:`process_count`: 0 and 1 outside a group).

Peer loss: a process that dies mid-run stalls every collective.
:func:`check_peers` turns the stall into a typed ``PeerLostException``
(a heartbeat and a timed barrier over the group's key-value store, where
the reference uses the ``jax.distributed`` store) or, with
``on_peer_loss="degrade"``, into a :class:`PeerLossReport` naming the
survivors and the lost ranks' row ranges, which the run completes
without and reports as ``unverified_row_ranges`` — partial results are
reported, never silent.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from deequ_tpu_torch.exceptions import PeerLostException

#: default heartbeat and barrier timeout (seconds) before a peer is lost
DEFAULT_PEER_TIMEOUT = 60.0

#: the key-value store of the group :func:`initialize_multi_host` joined
_STORE = None


def initialize_multi_host(
    init_method: str,
    world_size: int,
    rank: int,
    backend: str = "gloo",
    timeout: float = 300.0,
) -> None:
    """Join a process group: ``init_method`` is ``"tcp://host:port"`` (rank
    0 hosts the store there), ``world_size`` the number of processes and
    ``rank`` this one's index — where the reference's
    ``jax.distributed.initialize`` takes a coordinator address, a process
    count and a process id. Nothing in the environment is consulted."""
    import datetime

    import torch.distributed as dist

    global _STORE
    if not init_method.startswith("tcp://"):
        raise ValueError(f"init_method must be tcp://host:port, got {init_method!r}")
    host, _, port = init_method[len("tcp://"):].rpartition(":")
    wait = datetime.timedelta(seconds=timeout)
    store = dist.TCPStore(host, int(port), int(world_size), is_master=int(rank) == 0,
                          timeout=wait)
    dist.init_process_group(backend, store=store, rank=int(rank),
                            world_size=int(world_size), timeout=wait)
    _STORE = store


def process_count() -> int:
    """The group's world size (1 outside a group)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 outside a group)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def split_row_range(total_rows: int, n_parts: int, part: int) -> Tuple[int, int]:
    """Balanced [start, stop) split of ``total_rows`` into ``n_parts``: the
    first ``total_rows % n_parts`` parts carry one extra row, so no two
    parts differ by more than one row."""
    if n_parts <= 0:
        raise ValueError(f"n_parts must be >= 1, got {n_parts}")
    if not 0 <= part < n_parts:
        raise ValueError(f"part must be in [0, {n_parts}), got {part}")
    base, rem = divmod(max(int(total_rows), 0), n_parts)
    start = part * base + min(part, rem)
    return start, start + base + (1 if part < rem else 0)


def host_row_range(total_rows: int) -> Tuple[int, int]:
    """The [start, stop) rows of a globally ordered table this process
    ingests (:func:`split_row_range` by rank)."""
    return split_row_range(total_rows, process_count(), process_index())


# -- the cross-process state merge ---------------------------------------------------


def _all_gather_varlen(tensor, group=None) -> List:
    """Every rank's 1-D host ``tensor`` (their lengths may differ), in rank
    order: the lengths first, then the tensors padded to the longest."""
    import torch
    import torch.distributed as dist

    world = dist.get_world_size(group)
    size = torch.tensor([tensor.numel()], dtype=torch.int64)
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(sizes, size, group=group)
    longest = max(int(s.item()) for s in sizes)
    padded = torch.zeros(longest, dtype=tensor.dtype)
    padded[: tensor.numel()] = tensor
    out = [torch.zeros(longest, dtype=tensor.dtype) for _ in range(world)]
    dist.all_gather(out, padded, group=group)
    return [t[: int(s.item())] for t, s in zip(out, sizes)]


def _fold_leaf(tag: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if tag == "sum":
        return a + b
    if tag == "min":
        return np.minimum(a, b)
    if tag == "max":
        return np.maximum(a, b)
    if tag == "gather":
        return np.concatenate([a, b], axis=0)
    raise ValueError(f"unknown fold tag {tag!r}")


def merge_process_states(ops: Sequence, results: Sequence[Dict[str, np.ndarray]],
                         group=None) -> List[Dict[str, np.ndarray]]:
    """Every process's scan results folded in rank order: ``ops`` and
    ``results`` are this process's ``run_scan`` ops and results (every
    rank built the same ops). Each rank's leaves travel as two host
    tensors over the group — its layout (ndim and shape a leaf) and its
    values as f64, exact for the integer leaves below 2^53 — and fold by
    their tags: sum, min and max elementwise, gather leaves concatenated
    rank-major. Returns the merged results, as ``run_scan`` returns
    them."""
    import torch

    keys = [list(op.tags) for op in ops]
    layout, parts, int_leaf = [], [], []
    for op_keys, result in zip(keys, results):
        for key in op_keys:
            leaf = np.asarray(result[key])
            layout += [leaf.ndim, *leaf.shape]
            parts.append(leaf.astype(np.float64).ravel())
            int_leaf.append(np.issubdtype(leaf.dtype, np.integer))
    heads = _all_gather_varlen(torch.tensor(layout, dtype=torch.int64), group)
    values = _all_gather_varlen(
        torch.from_numpy(np.concatenate(parts) if parts else np.zeros(0)), group
    )
    merged: Optional[List[Dict[str, np.ndarray]]] = None
    for head, vals in zip(heads, values):
        head, vals = head.numpy(), vals.numpy()
        h = v = j = 0
        rank_results = []
        for op, op_keys in zip(ops, keys):
            out = {}
            for key in op_keys:
                ndim = int(head[h])
                shape = tuple(int(d) for d in head[h + 1:h + 1 + ndim])
                h += 1 + ndim
                size = int(np.prod(shape, dtype=np.int64))
                leaf = vals[v:v + size].reshape(shape)
                out[key] = leaf.astype(np.int64) if int_leaf[j] else leaf.copy()
                v += size
                j += 1
            rank_results.append(out)
        if merged is None:
            merged = rank_results
            continue
        merged = [
            {key: _fold_leaf(op.tags[key], acc[key], new[key]) for key in acc}
            for op, acc, new in zip(ops, merged, rank_results)
        ]
    return merged


# -- peer loss ---------------------------------------------------------------------


def probe_liveness(
    expected: Sequence[int],
    timeout: float,
    probe: Callable[[float], Sequence[int]],
) -> Tuple[List[int], List[int]]:
    """Run one liveness probe over the ``expected`` ids and attribute the
    outcome: ``(alive, lost)``, both sorted. ``probe(timeout)`` returns the
    responsive ids; a ``TimeoutError`` means the stall could not be
    attributed and propagates to the caller."""
    alive = sorted(int(p) for p in probe(timeout))
    expected_set = {int(i) for i in expected}
    lost = sorted(expected_set - set(alive))
    return [p for p in alive if p in expected_set], lost


def validate_loss_mode(value: str, param: str) -> None:
    """The loss policies are ``"fail"`` (raise typed) and ``"degrade"``
    (report and go on)."""
    if value not in ("fail", "degrade"):
        raise ValueError(f"{param} must be 'fail' or 'degrade', got {value!r}")


def run_liveness_check(
    expected: Sequence[int],
    timeout: float,
    probe: Callable[[float], Sequence[int]],
    unattributable: Callable[[TimeoutError], BaseException],
) -> Tuple[List[int], List[int]]:
    """The core of every membership check: run the probe, attribute the
    losses, and turn an unattributable ``TimeoutError`` into the caller's
    typed exception — even a "degrade" caller cannot tell which rows to
    leave out without attribution."""
    try:
        return probe_liveness(expected, timeout, probe)
    except TimeoutError as e:
        raise unattributable(e) from e


@dataclass
class PeerLossReport:
    """The outcome of one peer check: ``lost`` the ranks that stopped
    responding, ``unverified_row_ranges`` their :func:`host_row_range`
    rows, which a degraded run completes without."""

    n_processes: int
    surviving: List[int] = field(default_factory=list)
    lost: List[int] = field(default_factory=list)
    unverified_row_ranges: List[Tuple[int, int]] = field(default_factory=list)

    @property
    def degraded(self) -> bool:
        return bool(self.lost)


# every process runs the same program, so the k-th check_peers call
# of each agrees on tag k: a shared name no clock could give
_PEER_PROBE_SEQ = itertools.count()


def _default_peer_probe(timeout: float) -> List[int]:
    """Liveness over the group's key-value store: this process publishes a
    heartbeat key and waits at a barrier (a counter every process adds
    one to); when the barrier times out, the peers whose heartbeat keys
    exist are alive. Returns the responsive ranks (this one always).
    Raises TimeoutError when every peer heartbeated yet the barrier
    stalled: the stall cannot be attributed."""
    n_proc = process_count()
    pid = process_index()
    if _STORE is None or n_proc <= 1:
        return list(range(n_proc))
    tag = f"deequ_tpu_torch_peers_{next(_PEER_PROBE_SEQ)}"
    _STORE.set(f"{tag}/heartbeat/{pid}", "alive")
    arrived = _STORE.add(f"{tag}/arrived", 1)
    deadline = time.monotonic() + timeout
    while arrived < n_proc and time.monotonic() < deadline:
        time.sleep(0.01)
        arrived = _STORE.add(f"{tag}/arrived", 0)
    if arrived >= n_proc:
        return list(range(n_proc))
    alive = [pid] + [peer for peer in range(n_proc)
                     if peer != pid and _STORE.check([f"{tag}/heartbeat/{peer}"])]
    if len(alive) == n_proc:
        raise TimeoutError(
            f"barrier timed out after {timeout:g}s with all {n_proc} heartbeats present"
        )
    return sorted(alive)


def check_peers(
    total_rows: int,
    timeout: float = DEFAULT_PEER_TIMEOUT,
    on_peer_loss: str = "fail",
    probe: Optional[Callable[[float], Sequence[int]]] = None,
) -> PeerLossReport:
    """Check that every peer process is still reachable — the
    multi-process counterpart of the watchdog. ``probe(timeout)`` returns
    the responsive ranks (default :func:`_default_peer_probe`; tests
    inject one). On a loss, ``on_peer_loss="fail"`` raises
    ``PeerLostException`` naming the lost ranks, and ``"degrade"`` returns
    a report whose ``unverified_row_ranges`` are their row ranges, also
    recorded on ``ScanStats`` (``record_unverified``, kind ``peer_lost``)
    so ``VerificationResult`` reports them. An unattributable stall raises
    under either policy."""
    validate_loss_mode(on_peer_loss, "on_peer_loss")
    n_proc = process_count()
    report = PeerLossReport(n_processes=n_proc)
    if n_proc <= 1:
        report.surviving = list(range(n_proc))
        return report
    alive, lost = run_liveness_check(
        range(n_proc), timeout, probe or _default_peer_probe,
        lambda e: PeerLostException(
            f"the process barrier timed out after {timeout:g}s and the stall could "
            f"not be attributed to specific peers: {e}",
        ),
    )
    report.surviving, report.lost = alive, lost
    if not lost:
        return report
    for peer in lost:
        start, stop = split_row_range(total_rows, n_proc, peer)
        if stop > start:
            report.unverified_row_ranges.append((start, stop))
    if on_peer_loss == "fail":
        raise PeerLostException(
            f"lost contact with process(es) {lost} after {timeout:g}s (surviving: "
            f"{alive}); run again, or pass on_peer_loss='degrade' to finish on the "
            "survivors with the lost processes' rows reported unverified",
            lost_processes=tuple(lost),
        )
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    SCAN_STATS.bump(peer_losses=len(lost))
    for start, stop in report.unverified_row_ranges:
        SCAN_STATS.record_unverified(start, stop, reason=f"peer_lost:{','.join(map(str, lost))}",
                                     kind="peer_lost")
    if not report.unverified_row_ranges:
        # a source that does not know its rows cannot name the lost ones,
        # but the loss is still reported
        SCAN_STATS.record_degradation(
            "peer_lost", lost_processes=sorted(lost),
            reason="unverified row ranges unknown (no source row count)",
        )
    return report
