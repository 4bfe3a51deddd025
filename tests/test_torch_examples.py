"""Three of the reference's example flows rebuilt on the port and held
against the reference's own output (``examples/data_profiling_example.py``,
``constraint_suggestion_example.py``, ``deequ_migration_example.py``), on
the CPU:

- profiling: the profiles' JSON field by field (sums and moments within
  ``torch_parity.REL_BOUNDS``, every other field as text) and the
  suggested code, identical;
- suggestion with a held-out tenth: every suggestion's description,
  current value and code, and the evaluation JSON, identical;
- migration: the imported history's count, the anomaly check's status
  and the migrated Mean state's value, identical.
"""

import importlib
import json
import os
import pathlib
import struct

import numpy as np
import pytest
import torch

from deequ_tpu.parallel.mesh import use_mesh
from deequ_tpu_torch import use_device
from test_io_and_distance import TITANIC
from test_torch_profiles import assert_json_parity

pytestmark = pytest.mark.torch_port

EXAMPLES_DIR = pathlib.Path(__file__).resolve().parent.parent / "examples"


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The port on the CPU; the reference's example on one device under
    DEEQU_TPU_COMPUTE=f64 (its min/max exact)."""
    monkeypatch.syspath_prepend(str(EXAMPLES_DIR))
    monkeypatch.setenv("DEEQU_TPU_COMPUTE", "f64")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with use_device("cpu"), use_mesh(None):
        yield
    torch.set_num_threads(threads)


def _reference_example(name):
    return importlib.import_module(name).run()


def _profiling_flow():
    """examples/data_profiling_example.py on the port."""
    from deequ_tpu_torch.data.io import read_csv
    from deequ_tpu_torch.data.table import ColumnarTable
    from deequ_tpu_torch.profiles import ColumnProfilerRunner
    from deequ_tpu_torch.suggestions import ConstraintSuggestionRunner, Rules

    if os.path.exists(TITANIC):
        data = read_csv(TITANIC)
    else:
        data = ColumnarTable.from_pydict(
            {"Age": [22.0, 38.0, None, 35.0], "Sex": ["m", "f", "f", "m"]})
    profiles = ColumnProfilerRunner.on_data(data).run()
    suggestions = (ConstraintSuggestionRunner.on_data(data)
                   .add_constraint_rules(Rules.DEFAULT).run())
    return profiles, suggestions


def test_data_profiling_flow():
    profiles, suggestions = _profiling_flow()
    ref = _reference_example("data_profiling_example")
    assert_json_parity(ref.column_profiles.to_json(), profiles.to_json(), "f64")
    assert_json_parity(ref.profiles_as_json(), suggestions.profiles_as_json(), "f64")
    assert [s.code_for_constraint for s in suggestions.all_suggestions] == [
        s.code_for_constraint for s in ref.all_suggestions]
    assert suggestions.all_suggestions


def test_constraint_suggestion_flow():
    """examples/constraint_suggestion_example.py on the port."""
    from deequ_tpu_torch import ColumnarTable
    from deequ_tpu_torch.suggestions import ConstraintSuggestionRunner, Rules

    data = ColumnarTable.from_pydict({
        "productName": [f"thingy-{i % 7}" for i in range(200)],
        "totalNumber": [float(i % 50 + 1) for i in range(200)],
        "status": (["IN_TRANSIT"] * 120 + ["DELAYED"] * 60 + ["UNKNOWN"] * 20),
        "valuable": [None if i % 4 else "true" for i in range(200)],
    })
    result = (ConstraintSuggestionRunner.on_data(data)
              .add_constraint_rules(Rules.DEFAULT)
              .use_train_test_split_with_test_set_ratio(0.1, seed=0)
              .run())
    ref = _reference_example("constraint_suggestion_example")

    def rows(r):
        return {column: [(s.description, s.current_value, s.code_for_constraint)
                         for s in group] for column, group in r.suggestions.items()}

    assert rows(result) == rows(ref)
    assert result.verification_result is not None and result.verification_result.device == "cpu"
    assert result.verification_result.status.value == ref.verification_result.status.value
    assert result.evaluation_as_json() == ref.evaluation_as_json()
    assert result.suggestions_as_json() == ref.suggestions_as_json()


def test_deequ_migration_flow(tmp_path):
    """examples/deequ_migration_example.py on the port: a legacy
    repository JSON imported, a run whose anomaly check reads the
    migrated history, a legacy Mean state loaded."""
    from deequ_tpu_torch import CheckLevel, VerificationSuite
    from deequ_tpu_torch.analyzers import Mean, Size
    from deequ_tpu_torch.anomaly import RelativeRateOfChangeStrategy
    from deequ_tpu_torch.data.table import ColumnarTable
    from deequ_tpu_torch.interop import (
        import_repository_json,
        load_reference_state,
        reference_state_identifier,
    )
    from deequ_tpu_torch.repository import InMemoryMetricsRepository, ResultKey
    from deequ_tpu_torch.verification import AnomalyCheckConfig

    legacy_history = [
        {"resultKey": {"dataSetDate": day, "tags": {"dataset": "orders"}},
         "analyzerContext": {"metricMap": [{
             "analyzer": {"analyzerName": "Size", "where": None},
             "metric": {"metricName": "DoubleMetric", "entity": "Dataset",
                        "instance": "*", "name": "Size", "value": 1000.0 + day}}]}}
        for day in range(1, 5)
    ]
    repository = InMemoryMetricsRepository()
    imported = import_repository_json(json.dumps(legacy_history), repository)
    table = ColumnarTable.from_pydict({"v": list(np.arange(1005.0))})
    result = (
        VerificationSuite.on_data(table)
        .use_repository(repository)
        .save_or_append_result(ResultKey(10, {"dataset": "orders"}))
        .add_anomaly_check(
            RelativeRateOfChangeStrategy(max_rate_decrease=0.5, max_rate_increase=2.0),
            Size(), AnomalyCheckConfig(CheckLevel.WARNING, "size continuity"))
        .run()
    )
    ident = reference_state_identifier(Mean("price"))
    (tmp_path / f"states-{ident}.bin").write_bytes(struct.pack(">dq", 5000.0, 40))
    mean_state = load_reference_state(str(tmp_path / "states"), Mean("price"))
    got = {"imported_results": imported, "anomaly_check_status": str(result.status),
           "migrated_mean": mean_state.metric_value()}
    assert result.device == "cpu"
    assert got == _reference_example("deequ_migration_example")
    assert got["migrated_mean"] == 125.0
    saved = repository.load_by_key(ResultKey(10, {"dataset": "orders"}))
    assert saved.analyzer_context.metric_map[Size()].value.get() == 1005.0
