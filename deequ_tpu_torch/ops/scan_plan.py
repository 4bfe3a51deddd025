"""Which kernel each op of one scan runs — the port's subset of
``deequ_tpu/ops/scan_plan.py``.

A KLL summary op carries two updates: ``update`` sorts the chunk
(``ops/kll_device.py``, K3) and ``select_update`` pins the same ranks with
the radix select (``ops/select_device.py``, K4). The reference selects
only on resident scans (``use_select = resident and ...``), and so does
the port: :func:`plan_scan_ops` routes an op to its ``select_update`` when
the scan walks a persisted table, the select is on, and the chunk's shape
is one where K4 beats K3 (:func:`select_beats_sort`); every other op keeps
its update. The plan's census (``select_ops``, ``sort_ops``) is what
``run_scan`` adds to ``ScanStats.device_select_passes`` and
``device_sort_passes``, once a chunk.

Every numeric column of the port rides f64, and K4 keys on the 64-bit
order of the f64 itself, so any column a select op reads is selectable
(the reference keeps its wide-f64 columns on the sort).

A plan that routes select ops also declares its ``hist_variant`` (the
reference's ``scan_plan.py:118-148``, ``:392-416``): the histogram variant
of ``ops/histogram_device.py`` resolved once for the plan by
``device_policy.resolve_hist_variant`` over the widest pass its select ops
declare (``ScanOp.hist_widths``), at the chunk's rows; "none" when the
plan routes no select. On the CPU it is bound around each select update
(:func:`_bind_hist_variant`), so the plain select's passes
(``select_device._select_batch``) count under it. On a card K4 counts its
passes inside its own kernel (``csrc/select.cu``), so there the variant is
declared, the update stays bare and no histogram is dispatched for it.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional, Sequence, Tuple


#: the rule's thresholds (:func:`select_beats_sort`)
SELECT_SMALL_SKETCH = 2048
SELECT_MIN_ROWS_PER_TARGET = 64


def select_beats_sort(rows: int, sketch_size: int) -> bool:
    """Whether K4's kernel summarises a chunk of ``rows`` rows faster than
    K3 at this sketch size, by the rule read from PERF.md's K4-vs-K3 table
    (``chip_smoke.py``'s ``select_shapes``: 1, 8 and 50 columns, 2^16 to
    2^25 rows, k = 2^8, 2^11, 2^14 on an H100). K4's passes count
    (k + 2)·256 bins a column whatever the rows, so with many targets and
    few rows a target the counts outweigh the rows: K3 won every measured
    shape with k = 2^14 and at most 2^19 rows (fewer than 64 rows a
    target), K4 every shape with k <= 2^11 and every one with 2^22 rows
    or more (by 7% less than K3 at one column and 2^22 rows, its one
    loss there)."""
    return sketch_size <= SELECT_SMALL_SKETCH or (
        rows >= SELECT_MIN_ROWS_PER_TARGET * (sketch_size + 2))


def encoded_ingest_enabled(param: Optional[bool] = None) -> bool:
    """The encoded-ingest switch (the reference's ``scan_plan.py:52-67``):
    an explicit True/False wins, then ``DEEQU_TORCH_ENCODED_INGEST`` ('0'
    turns it off, through the ``envcfg`` registry), then on. On, a column
    carrying a dictionary encoding rides the int16 code plane; off, every
    column packs decoded."""
    from deequ_tpu_torch.envcfg import env_value

    if param is not None:
        if not isinstance(param, (bool, int)) or param not in (0, 1):
            raise ValueError(f"encoded_ingest must be True/False, got {param!r}")
        return bool(param)
    return env_value("DEEQU_TORCH_ENCODED_INGEST")


def select_kernel_enabled(param: Optional[bool] = None) -> bool:
    """The select switch: an explicit True/False wins; None means on. (The
    reference also reads ``DEEQU_TPU_SELECT_KERNEL``; the port reads no
    environment switch yet.)"""
    if param is None:
        return True
    if not isinstance(param, (bool, int)) or param not in (0, 1):
        raise ValueError(f"select_kernel must be True/False, got {param!r}")
    return bool(param)


def plan_fusion_enabled(param: Optional[bool] = None) -> bool:
    """The cross-set grouping fusion switch (the reference's
    ``scan_plan.py:241``): an explicit True/False wins, then
    ``DEEQU_TORCH_PLAN_FUSION`` ('0' turns it off), then on."""
    from deequ_tpu_torch.envcfg import env_value

    if param is not None:
        if not isinstance(param, (bool, int)) or param not in (0, 1):
            raise ValueError(f"plan_fusion must be True/False, got {param!r}")
        return bool(param)
    return env_value("DEEQU_TORCH_PLAN_FUSION")


@dataclass(frozen=True)
class ScanPlan:
    """One scan's ops with their kernels chosen. ``select_ops`` and
    ``sort_ops`` count the ops a chunk that run the radix select and a
    device sort; ``variant`` is "select", "sort", "mixed" or "none";
    ``hist_variant`` the histogram variant of the select ops' passes
    ("scatter", "onehot", "pallas", or "none" with no select: module doc);
    ``encoded_columns`` are the columns on the int16 code plane. A packed
    plan (:func:`plan_packed_scan`) also counts its ``tenants`` and
    declares each one's contracts in ``members``."""

    ops: Tuple
    resident: bool
    select_ops: int
    sort_ops: int
    variant: str
    encoded_columns: Tuple[str, ...] = ()
    hist_variant: str = "none"
    tenants: int = 1
    members: Tuple = ()


def _bind_hist_variant(update: Callable, variant: str) -> Callable:
    """``update`` with the ambient histogram variant bound to ``variant``
    while it runs (``histogram_device.active_hist_variant``)."""
    from deequ_tpu_torch.ops.histogram_device import active_hist_variant

    def bound_update(*args):
        with active_hist_variant(variant):
            return update(*args)

    return bound_update


def plan_scan_ops(
    ops: Sequence,
    packer=None,
    resident: bool = False,
    select_kernel: Optional[bool] = None,
    chunk_rows: Optional[int] = None,
    platform: Optional[str] = None,
) -> ScanPlan:
    """Route each op for one scan (module doc); ``chunk_rows``: the scan's
    chunk capacity (None: no shape rule, and many rows to the variant
    policy); ``platform``: the scan's device type (None: the port's
    default device)."""
    from deequ_tpu_torch.ops.device_policy import default_platform, resolve_hist_variant

    use_select = select_kernel_enabled(select_kernel) and resident
    routed = [
        use_select and op.select_update is not None and (
            chunk_rows is None or select_beats_sort(chunk_rows, op.select_size))
        for op in ops
    ]
    hist_variant = "none"
    if any(routed):
        platform = platform or default_platform()
        hist_variant = resolve_hist_variant(
            tuple(w for op, sel in zip(ops, routed) if sel for w in op.hist_widths),
            rows=chunk_rows, platform=platform,
        )
    resolved = []
    n_select = n_sort = 0
    for op, sel in zip(ops, routed):
        if sel:
            update = op.select_update
            if platform == "cpu":
                update = _bind_hist_variant(update, hist_variant)
            resolved.append(replace(op, update=update, sorts_chunk=False))
            n_select += 1
        else:
            resolved.append(op)
            n_sort += int(op.sorts_chunk)
    if n_select and n_sort:
        variant = "mixed"
    elif n_select:
        variant = "select"
    elif n_sort:
        variant = "sort"
    else:
        variant = "none"
    return ScanPlan(
        ops=tuple(resolved),
        resident=resident,
        select_ops=n_select,
        sort_ops=n_sort,
        variant=variant,
        encoded_columns=tuple(packer.enc_names) if packer is not None else (),
        hist_variant=hist_variant,
    )


@dataclass(frozen=True)
class PackedMember:
    """One tenant's declared contracts inside a packed plan (the
    reference's ``scan_plan.PackedMember``): ``label`` names the member
    (its tenant), the other fields mirror the plan's contract fields. In a
    coalesced batch every member's declaration equals the shared plan's:
    the service admits only suites of one plan key. ``padding`` marks a
    padding slot, which the port never packs (the reference pads its
    tenant axis to a power of two to bound its compiled programs)."""

    label: str
    variant: str = "sort"
    ingest_variant: str = "decoded"
    encoded_columns: Tuple[str, ...] = ()
    padding: bool = False


def plan_packed_scan(
    ops: Sequence,
    packer=None,
    members: Sequence[PackedMember] = (),
    select_kernel: Optional[bool] = None,
    chunk_rows: Optional[int] = None,
    platform: Optional[str] = None,
) -> ScanPlan:
    """The multi-tenant packed plan (``serve/executor.py``): one op list
    every member of a coalesced batch runs, ``members`` declaring each
    one's contracts. Members are packed fresh a batch and never resident,
    so each op keeps its sorting update — what a serial scan of the same
    table runs, which the bit-for-bit contract needs. The plan's fetch
    contract is one fetch a coalesced batch."""
    base = plan_scan_ops(ops, packer, resident=False, select_kernel=select_kernel,
                         chunk_rows=chunk_rows, platform=platform)
    return replace(base, tenants=len(members), members=tuple(members))
