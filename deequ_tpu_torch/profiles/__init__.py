from deequ_tpu_torch.profiles.profiler import (
    ColumnProfile,
    ColumnProfiler,
    ColumnProfilerRunner,
    ColumnProfiles,
    NumericColumnProfile,
    OfflineProfileRuns,
    StandardColumnProfile,
)

__all__ = [
    "ColumnProfile",
    "ColumnProfiler",
    "ColumnProfilerRunner",
    "ColumnProfiles",
    "NumericColumnProfile",
    "OfflineProfileRuns",
    "StandardColumnProfile",
]
