"""The port's string analyzers (PatternMatch with the four built-in
patterns, MinLength, MaxLength, DataType) against the reference's on the
CPU, exact, with and without a where filter; the native C++ batch of
``deequ_tpu_torch/native`` against its plain Python versions and against
``deequ_tpu.native``; and the lookup-table memo (``ops/lut_cache.py``): a
second run over the same table builds no table again."""

import numpy as np
import pytest
import torch

import deequ_tpu.analyzers as ref_analyzers
import deequ_tpu_torch.analyzers as port_analyzers
from deequ_tpu import native as ref_native
from deequ_tpu.analyzers.runner import AnalysisRunner as RefRunner
from deequ_tpu.data.table import ColumnarTable as RefTable
from deequ_tpu_torch import native
from deequ_tpu_torch.analyzers.runner import AnalysisRunner as PortRunner
from deequ_tpu_torch.analyzers.scan import _classify_string
from deequ_tpu_torch.ops import hll, lut_cache
from torch_parity import port_table, ref_column

pytestmark = pytest.mark.torch_port

SAMPLES = [
    "", "a", "hello world", "x" * 7, "y" * 8, "z" * 31, "w" * 32, "v" * 100,
    "unicode: äöü 中文 🎉", "123", "-42", "3.14", "true", "false", "  spaces  ",
    "O'Brien", "-", "+ 5", ".", "1.2.3", "+-1", "- 7.", "True", "1e5",
    "user@example.com", '"quoted.local"@example.com', "user@[192.168.0.1]",
    "https://example.com/x?q=1", "ftp://host/file", "http://", "111-05-1130",
    "666-12-3456", "219-09-9999", "378282246310005", "4111 1111 1111 1111",
    "5500-0000-0000-0004", "6011000000000004", "4111111111111112x",
]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _table(n: int = 4000) -> RefTable:
    rng = np.random.default_rng(5)
    return RefTable([
        ref_column("s", "string",
                   codes=rng.integers(-1, len(SAMPLES), n).astype(np.int32),
                   dictionary=SAMPLES),
        ref_column("k", "integral", rng.integers(0, 10, n), rng.random(n) > 0.1),
        ref_column("f", "fractional", rng.normal(size=n), rng.random(n) > 0.2),
        ref_column("b", "boolean", rng.random(n) > 0.5, rng.random(n) > 0.3),
        ref_column("empty", "string", codes=np.full(n, -1, np.int32), dictionary=[]),
    ])


def _analyzers(module):
    p = module.Patterns
    out = []
    for where in (None, "k > 4"):
        out += [
            module.PatternMatch("s", p.EMAIL, where),
            module.PatternMatch("s", p.URL, where),
            module.PatternMatch("s", p.SOCIAL_SECURITY_NUMBER_US, where),
            module.PatternMatch("s", p.CREDITCARD, where),
            module.PatternMatch("s", r"^\d+$", where),
            module.MinLength("s", where),
            module.MaxLength("s", where),
            module.DataType("s", where),
            module.DataType("k", where),
            module.DataType("f", where),
            module.DataType("b", where),
        ]
    out += [
        module.MinLength("empty"),   # all null: the empty-state failure
        module.DataType("empty"),
        module.MinLength("k"),       # not a string column: precondition failure
        module.PatternMatch("f", "x"),
    ]
    return out


_RESULTS = {}


def _results():
    if not _RESULTS:
        ref = _table()
        refs, ports = _analyzers(ref_analyzers), _analyzers(port_analyzers)
        port_ctx = PortRunner.do_analysis_run(port_table(ref), ports, device="cpu")
        ref_ctx = RefRunner.do_analysis_run(ref, refs)
        _RESULTS["pairs"] = [(ref_ctx.metric(r), port_ctx.metric(p)) for r, p in zip(refs, ports)]
    return _RESULTS["pairs"]


def _value(metric):
    if not metric.value.is_success:
        exc = metric.value.exception
        return ("failure", type(exc).__name__, str(exc))
    v = metric.value.get()
    if hasattr(v, "values"):  # a Distribution
        return v.number_of_bins, {k: (d.absolute, d.ratio) for k, d in v.values.items()}
    return v


@pytest.mark.parametrize("case", range(26))
def test_string_analyzer_matches_reference(case):
    ref_metric, port_metric = _results()[case]
    assert (port_metric.name, port_metric.instance) == (ref_metric.name, ref_metric.instance)
    assert port_metric.entity.value == ref_metric.entity.value
    assert _value(port_metric) == _value(ref_metric)


def test_string_analyzers_against_python():
    """The metrics against plain Python over the table's strings."""
    import re

    ref = _table()
    s = port_table(ref)["s"]
    rows = [SAMPLES[c] if c >= 0 else None for c in s.codes.tolist()]
    valid = [r for r in rows if r is not None]
    pairs = _results()
    email = sum(1 for r in valid if re.search(port_analyzers.Patterns.EMAIL, r))
    assert pairs[0][1].value.get() == email / len(rows)
    assert pairs[5][1].value.get() == min(len(r) for r in valid)
    assert pairs[6][1].value.get() == max(len(r) for r in valid)
    dist = pairs[7][1].value.get()
    classes = [_classify_string(r) for r in valid]
    assert dist.values["Unknown"].absolute == len(rows) - len(valid)
    for slot, name in enumerate(("Fractional", "Integral", "Boolean", "String"), 1):
        assert dist.values[name].absolute == classes.count(slot)


def test_native_matches_plain_python():
    rng = np.random.default_rng(0)
    values = SAMPLES + [
        "".join(chr(int(c)) for c in rng.integers(32, 1000, int(rng.integers(0, 50))))
        for _ in range(500)
    ] + ["nul\x00inside"]
    assert native.hash_strings(values, 42).tolist() == hll.hash_strings_plain(values, 42).tolist()
    assert native.hash_strings(["abc"], 7)[0] == hll.xxhash64_bytes(b"abc", 7)
    assert native.utf8_lengths(values).tolist() == [len(v) for v in values]
    assert native.classify_strings(SAMPLES).tolist() == [_classify_string(v) for v in SAMPLES]
    assert native.hash_strings([], 42).shape == (0,)


def test_native_matches_reference_native():
    assert ref_native.available()
    obj = np.array(SAMPLES, dtype=object)
    assert native.hash_strings(obj, 42).tolist() == ref_native.hash_strings(SAMPLES, 42).tolist()
    assert native.classify_strings(obj).tolist() == ref_native.classify_strings(SAMPLES).tolist()
    assert native.utf8_lengths(obj).tolist() == ref_native.utf8_lengths(SAMPLES).tolist()


def test_native_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "kernels.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(native.NativeBuildError, match="g\\+\\+ failed"):
        native.build()


def test_second_run_builds_no_lookup_table():
    ref = _table()
    table = port_table(ref)
    analyzers = _analyzers(port_analyzers)[:11] + [port_analyzers.ApproxCountDistinct("s")]
    PortRunner.do_analysis_run(table, analyzers, device="cpu")
    before = lut_cache.BUILDS
    again = PortRunner.do_analysis_run(table, analyzers, device="cpu")
    assert lut_cache.BUILDS == before
    assert all(m.value.is_success for m in again.metric_map.values())
    # a new dictionary object builds anew
    PortRunner.do_analysis_run(port_table(_table()), analyzers[:1], device="cpu")
    assert lut_cache.BUILDS == before + 1
