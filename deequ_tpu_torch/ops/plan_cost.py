"""The plan COST MODEL — one predicted-cost function for a scan plan (the
port of ``deequ_tpu/ops/plan_cost.py``).

What makes a plan expensive is known in several places: the histogram
width caps (``ops/device_policy.py``: :func:`hist_cpu_cap`,
:func:`hist_accel_cap`), the host-or-device grouping threshold
(``DEEQU_TORCH_HOST_GROUP_LIMIT``, ``ops/segment.py``) and the dispatch
overhead. :class:`PlanCostModel` puts them behind one deliberately small
closed-form predictor in abstract COST UNITS (about host-equivalent work;
only ordering and ratios mean anything, never wall seconds).

Its consumer in the reference is the serving admission tier (a queue's
summed predicted cost over its drain rate gives ``retry_after_s``, and the
brownout ladder reads queued-cost pressure); the port's ``serve/`` comes
later, and until then the tests hold the model's contract: it is
nondecreasing in every feature, because admission keyed on a
non-monotone predictor would invert under load.

The model's inputs are :class:`PlanFeatures`; its output :class:`PlanCost`
splits transfer / compute / fetch and counts device dispatches (each
carries a fixed launch overhead).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

#: fixed per-dispatch launch overhead, in cost units (the reference's
#: scale: its BASELINE config 1 round trip in the abstract unit)
DISPATCH_OVERHEAD = 4096.0


@dataclass(frozen=True)
class PlanFeatures:
    """What the predictor sees of a plan. Every field is a size or a
    count; the model is nondecreasing in each of them."""

    #: rows the plan scans (per tenant)
    rows: int
    #: plain fused scan ops (monoid folds: completeness, mean, ...)
    scan_ops: int = 0
    #: device-sort ops (KLL on the sort path): O(n log n)
    sort_ops: int = 0
    #: select ops (K4, the radix select): O(n) passes
    select_ops: int = 0
    #: histogram widths, one per histogram dispatch
    hist_widths: Tuple[int, ...] = ()
    #: dense grouping keyspaces, one per grouping pass
    group_keyspaces: Tuple[int, ...] = ()
    #: tenant-axis width (a packed serving batch scales per-tenant work)
    tenants: int = 1
    #: columns riding the encoded (code plane + decode table) ingest
    encoded_columns: int = 0


@dataclass(frozen=True)
class PlanCost:
    """Predicted cost split (abstract units — ordering is the API)."""

    transfer: float
    compute: float
    fetch: float
    dispatches: int

    @property
    def total(self) -> float:
        return (
            self.transfer + self.compute + self.fetch
            + DISPATCH_OVERHEAD * self.dispatches
        )


class PlanCostModel:
    """The predictor. It reads the caps and the host-group threshold at
    PREDICT time, not at construction, so a switch flipped between suites
    reprices the next prediction."""

    def __init__(self, platform: Optional[str] = None):
        self._platform = platform

    def _resolve_platform(self) -> str:
        """The given platform, else the port's default device: "cuda" where
        it resolves to a card, "cpu" otherwise."""
        if self._platform is not None:
            return self._platform
        from deequ_tpu_torch.ops.device_policy import default_platform

        return default_platform()

    def predict(self, f: PlanFeatures) -> PlanCost:
        """Nondecreasing in every :class:`PlanFeatures` field (the
        monotonicity contract): every term below is a nonnegative,
        nondecreasing function of its inputs, and features only ever ADD
        terms."""
        from deequ_tpu_torch.ops.device_policy import hist_accel_cap, hist_cpu_cap
        from deequ_tpu_torch.ops.segment import host_group_limit

        rows = max(int(f.rows), 0)
        tenants = max(int(f.tenants), 1)
        platform = self._resolve_platform()
        cap = hist_cpu_cap() if platform == "cpu" else hist_accel_cap()
        host_limit = host_group_limit()

        # transfer: pack + copy of the value/mask planes; an encoded
        # column adds its code plane and decode table
        transfer = float(rows) * (4.0 + 2.0 * max(f.encoded_columns, 0))

        # compute: one linear pass per fused scan/select op; device sorts
        # pay the n log n factor
        log_rows = math.log2(rows + 2)
        compute = float(rows) * (
            max(f.scan_ops, 0)
            + 2.0 * max(f.select_ops, 0)
            + 4.0 * max(f.sort_ops, 0) * log_rows
        )

        # fetch: the fused pass's ONE state-vector fetch
        fetch = 64.0 * (max(f.scan_ops, 0) + max(f.select_ops, 0)
                        + max(f.sort_ops, 0))
        dispatches = 1 if (f.scan_ops or f.select_ops or f.sort_ops) else 0

        # histogram dispatches: past the width cap a 4x step, still
        # nondecreasing in width
        for w in f.hist_widths:
            w = max(int(w), 0)
            dispatches += 1
            compute += float(rows) + (float(w) if w <= cap else 4.0 * w)
            fetch += float(w)

        # grouping passes: at or below the host-group limit the counts
        # fold on the host (no dispatch); above it one device count and
        # one O(keyspace) counts fetch a pass
        for k in f.group_keyspaces:
            k = max(int(k), 0)
            compute += float(rows) + float(k)
            if rows > host_limit:
                dispatches += 1
                fetch += float(k)

        # the tenant axis multiplies per-tenant work, not dispatches: K
        # cheap tenants amortize, K heavy ones do not
        return PlanCost(
            transfer=transfer * tenants,
            compute=compute * tenants,
            fetch=fetch * tenants,
            dispatches=dispatches,
        )

    def estimate_suite(
        self, analyzers: Sequence, rows: int, tenants: int = 1
    ) -> PlanCost:
        """Price one suite from its analyzer list. Grouping keyspaces are
        unknown before the scan, so each grouping pass prices at its worst
        admissible case, ``min(rows + 1, dense limit)`` — monotone in rows
        and never an underestimate."""
        from deequ_tpu_torch.analyzers.runner import _is_grouping_shared
        from deequ_tpu_torch.ops.scan_plan import select_kernel_enabled
        from deequ_tpu_torch.ops.segment import DENSE_KEYSPACE_LIMIT

        scan = sort = select = 0
        widths = []
        keyspaces = []
        for a in analyzers:
            name = type(a).__name__
            if _is_grouping_shared(a):
                keyspaces.append(min(int(rows) + 1, DENSE_KEYSPACE_LIMIT))
            elif name == "Histogram":
                widths.append(min(int(rows) + 1, 1 << 12))
            elif "Quantile" in name or "KLL" in name:
                if select_kernel_enabled(None):
                    select += 1
                else:
                    sort += 1
            else:
                scan += 1
        return self.predict(PlanFeatures(
            rows=int(rows),
            scan_ops=scan,
            sort_ops=sort,
            select_ops=select,
            hist_widths=tuple(widths),
            group_keyspaces=tuple(keyspaces),
            tenants=tenants,
        ))


#: the process-default model
PLAN_COST_MODEL = PlanCostModel()
