"""Out-of-core spill engine for high-cardinality grouping states (the
port's copy of ``deequ_tpu/spill``; host numpy, no device work).

Frequency-state deltas fold in host memory under a byte budget, spill as
canonically sorted binary runs past it, and merge back k-way at finalize
as a bounded stream of blocks the metric layer consumes directly, so a
grouping whose distinct count outgrows memory costs disk bandwidth
instead of an out-of-memory failure. Run files and their blocks are the
reference's byte for byte.
"""

from deequ_tpu_torch.spill.store import (
    DEFAULT_BUDGET_BYTES,
    SpilledFrequencies,
    SpillingFrequencyStore,
    budget_batch_rows,
    resolve_group_budget,
)

__all__ = [
    "DEFAULT_BUDGET_BYTES",
    "SpilledFrequencies",
    "SpillingFrequencyStore",
    "budget_batch_rows",
    "resolve_group_budget",
]
