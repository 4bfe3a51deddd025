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
(the reference keeps its wide-f64 columns on the sort). There is one
histogram kernel entry, so no histogram-variant resolution either.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence, Tuple


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


def select_kernel_enabled(param: Optional[bool] = None) -> bool:
    """The select switch: an explicit True/False wins; None means on. (The
    reference also reads ``DEEQU_TPU_SELECT_KERNEL``; the port reads no
    environment switch yet.)"""
    if param is None:
        return True
    if not isinstance(param, (bool, int)) or param not in (0, 1):
        raise ValueError(f"select_kernel must be True/False, got {param!r}")
    return bool(param)


@dataclass(frozen=True)
class ScanPlan:
    """One scan's ops with their kernels chosen. ``select_ops`` and
    ``sort_ops`` count the ops a chunk that run the radix select and a
    device sort; ``variant`` is "select", "sort", "mixed" or "none";
    ``encoded_columns`` are the columns on the int16 code plane."""

    ops: Tuple
    resident: bool
    select_ops: int
    sort_ops: int
    variant: str
    encoded_columns: Tuple[str, ...] = ()


def plan_scan_ops(
    ops: Sequence,
    packer=None,
    resident: bool = False,
    select_kernel: Optional[bool] = None,
    chunk_rows: Optional[int] = None,
) -> ScanPlan:
    """Route each op for one scan (module doc); ``chunk_rows``: the scan's
    chunk capacity (None: no shape rule)."""
    use_select = select_kernel_enabled(select_kernel) and resident
    resolved = []
    n_select = n_sort = 0
    for op in ops:
        if use_select and op.select_update is not None and (
                chunk_rows is None or select_beats_sort(chunk_rows, op.select_size)):
            resolved.append(replace(op, update=op.select_update, sorts_chunk=False))
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
    )
