"""The port's pluggable filesystem (``data/fs.py``) and multi-process
helpers (``parallel/distributed.py``) on the CPU: twins of the 5 tests of
tests/test_fs_and_distributed.py under the same names.

The multi-process twin starts two real processes
(``tools/multiprocess_merge.py``) that join a gloo process group over
localhost, each scans its ``host_row_range`` of the chip-smoke schema and
the states merge across the group in rank order; the merged metrics equal
the reference's run of the whole table (in its f64 plane) and the port's
one-process run. Where the reference patches
``jax.process_count`` / ``jax.process_index``, the twins patch the port's
``process_count`` / ``process_index`` (the group's world size and rank).
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from deequ_tpu_torch.data.fs import (
    _REGISTRY,
    InMemoryFileSystem,
    LocalFileSystem,
    filesystem_for,
    register_filesystem,
    strip_scheme,
)
from deequ_tpu_torch.parallel import distributed
from torch_parity import REL_BOUNDS, ref_column

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def mem_scheme():
    """A fresh in-memory filesystem registered as ``mem://``, removed after."""
    mem = InMemoryFileSystem()
    previous = _REGISTRY.get("mem")
    register_filesystem("mem", lambda path: mem)
    yield mem
    if previous is None:
        _REGISTRY.pop("mem", None)
    else:
        _REGISTRY["mem"] = previous


def test_local_resolution():
    assert filesystem_for("/tmp/x") is filesystem_for("/var/y")
    assert isinstance(filesystem_for("/tmp/x"), LocalFileSystem)
    assert isinstance(filesystem_for("file:///tmp/x"), LocalFileSystem)
    assert strip_scheme("file:///tmp/x") == "/tmp/x"
    assert strip_scheme("/tmp/x") == "/tmp/x"
    assert strip_scheme("mem://bucket/x") == "mem://bucket/x"


def test_registered_scheme_backs_state_provider(mem_scheme):
    """FileSystemStateProvider works against any registered filesystem."""
    from deequ_tpu_torch.analyzers import Mean
    from deequ_tpu_torch.analyzers.states import MeanState
    from deequ_tpu_torch.states import FileSystemStateProvider

    provider = FileSystemStateProvider("mem://bucket/states")
    provider.persist(Mean("x"), MeanState(10.0, 4))
    assert any(k.startswith("mem://bucket/states/") for k in mem_scheme.files)
    assert provider.load(Mean("x")) == MeanState(10.0, 4)
    assert provider.load(Mean("other")) is None


def test_registered_scheme_backs_metrics_repository(mem_scheme):
    from deequ_tpu_torch.analyzers import Size
    from deequ_tpu_torch.analyzers.runner import AnalyzerContext
    from deequ_tpu_torch.metrics import DoubleMetric, Entity
    from deequ_tpu_torch.repository import AnalysisResult, ResultKey
    from deequ_tpu_torch.repository.fs import FileSystemMetricsRepository
    from deequ_tpu_torch.tryresult import Success

    repo = FileSystemMetricsRepository("mem://bucket/metrics.json")
    key = ResultKey(1000, {"env": "test"})
    ctx = AnalyzerContext({Size(): DoubleMetric(Entity.DATASET, "Size", "*", Success(5.0))})
    repo.save(AnalysisResult(key, ctx))
    assert "mem://bucket/metrics.json" in mem_scheme.files

    loaded = repo.load_by_key(key)
    assert loaded is not None
    assert loaded.analyzer_context.metric_map[Size()].value.get() == 5.0


def test_host_row_range_balanced(monkeypatch):
    """0 rows, more processes than rows, and balance."""
    from deequ_tpu_torch.parallel.distributed import host_row_range

    def patch(n_proc, pid):
        monkeypatch.setattr(distributed, "process_count", lambda: n_proc)
        monkeypatch.setattr(distributed, "process_index", lambda: pid)

    for total, n_proc in [(10, 3), (8, 8), (0, 4), (3, 8), (100, 1)]:
        seen = []
        for pid in range(n_proc):
            patch(n_proc, pid)
            start, stop = host_row_range(total)
            assert 0 <= start <= stop <= total
            seen.extend(range(start, stop))
        assert seen == list(range(total)), (total, n_proc)

    # one process owns the whole table
    patch(1, 0)
    assert host_row_range(7) == (0, 7)


def _same(got, want, name):
    if isinstance(want, str) or isinstance(got, str):
        return got == want
    if math.isnan(want):
        return math.isnan(got)
    rel = REL_BOUNDS.get(name, 0.0)
    return got == want or abs(got - want) <= rel * max(abs(got), abs(want))


def _reference_metrics(table, analyzers) -> dict:
    """The reference's AnalysisRunner over the same table (the arrays
    handed over as they are) and the same analyzers, in its exact f64
    plane: ``{repr(analyzer): value}``."""
    import deequ_tpu.analyzers as ref_analyzers
    from deequ_tpu.analyzers.runner import AnalysisRunner as RefRunner
    from deequ_tpu.data.table import ColumnarTable as RefTable

    cols = []
    for col in table.columns.values():
        if col.dtype.value == "string":
            cols.append(ref_column(col.name, "string", codes=col.codes,
                                   dictionary=col.dictionary))
        else:
            cols.append(ref_column(col.name, col.dtype.value, col.values, col.mask))
    refs = [getattr(ref_analyzers, type(a).__name__)(
        **{f.name: getattr(a, f.name) for f in dataclasses.fields(a)}) for a in analyzers]
    assert [repr(r) for r in refs] == [repr(a) for a in analyzers]
    ctx = RefRunner.do_analysis_run(RefTable(cols), refs)
    return {repr(r): ctx.metric(r).value.get() for r in refs}


def test_multihost_cross_process_state_merge(tmp_path, monkeypatch):
    """Two real OS processes join a gloo group, each ingests its
    host_row_range and scans it, their flat state vectors are
    all-gathered as host tensors and folded in rank order: the merged
    metrics equal the reference's run of the whole table (the extrema
    exact in its f64 plane), and a one-process run of the port's."""
    if not torch.distributed.is_gloo_available():
        pytest.skip("this torch build has no gloo backend, the group the merge runs over")
    rows = 20_000
    out = tmp_path / "merged.json"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "multiprocess_merge.py"), "--spawn", "2",
         "--rows", str(rows), "--seed", "3", "--device", "cpu", "--timeout", "110",
         "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    merged = json.loads(out.read_text())
    assert merged["world"] == 2 and merged["shard"] == [0, rows // 2]

    sys.path.insert(0, REPO)
    import chip_smoke

    sys.path.insert(0, os.path.join(REPO, "tools"))
    from multiprocess_merge import metric_values, scan_analyzers

    from deequ_tpu_torch.analyzers.runner import AnalysisRunner

    table = chip_smoke.make_table(rows, 3)
    analyzers = scan_analyzers(table)
    monkeypatch.setenv("DEEQU_TPU_COMPUTE", "f64")
    reference = _reference_metrics(table, analyzers)
    whole = metric_values(AnalysisRunner.do_analysis_run(table, analyzers, device="cpu"),
                          analyzers)
    assert set(merged["metrics"]) == set(reference) == set(whole)
    for a in analyzers:
        key, name = repr(a), type(a).__name__
        got = merged["metrics"][key]
        assert _same(got, reference[key], name), (key, got, reference[key])
        assert _same(got, whole[key], name), (key, got, whole[key])
