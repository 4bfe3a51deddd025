"""deequ_tpu_torch — data-quality verification on PyTorch and CUDA.

The port of ``deequ_tpu`` (JAX on a TPU) to an NVIDIA H100. It keeps the
reference's module paths and names, so the counterpart of
``deequ_tpu/ops/segment.py`` is ``deequ_tpu_torch/ops/segment.py``. It
imports ``torch`` and numpy, never ``jax`` and nothing of ``deequ_tpu``.

Entry points run on ``cuda`` unless the caller asks for the CPU, with
``use_device("cpu")`` or a ``device=`` argument; without a CUDA device
and without that request they raise ``DeviceUnavailableException``. The
device computes in native float64.

The port carries ``VerificationSuite.run`` over an in-memory
``ColumnarTable``: the scan analyzers (Size, Completeness, Compliance,
Minimum, Maximum, Mean, Sum, StandardDeviation, Correlation), the string
analyzers (PatternMatch, MinLength, MaxLength, DataType, each a lookup
table over the dictionary built once per distinct value, the lengths and
type classes by the native C++ batch of ``native/``) and the sketch
analyzers (ApproxCountDistinct, whose registers come from the hand-written
CUDA kernel of ``csrc/hll.cu``; KLLSketch, ApproxQuantile,
ApproxQuantiles, sorted a chunk at a time on the device) fused into one
pass; the grouping analyzers (Uniqueness, UniqueValueRatio, Distinctness,
CountDistinct, Entropy, MutualInformation) and Histogram, whose dense
counts run the hand-written CUDA histogram of ``csrc/bincount.cu``. Every
in-memory ``Check`` method but the anomaly check is carried.
"""

from deequ_tpu_torch.checks import Check, CheckLevel, CheckStatus
from deequ_tpu_torch.constraints import ConstrainableDataTypes
from deequ_tpu_torch.data.table import ColumnarTable
from deequ_tpu_torch.device import use_device
from deequ_tpu_torch.exceptions import (
    DeviceException,
    DeviceOOMException,
    DeviceUnavailableException,
    NotYetPortedException,
)
from deequ_tpu_torch.metrics import DoubleMetric, Entity, HistogramMetric, Metric
from deequ_tpu_torch.verification import VerificationResult, VerificationSuite

__version__ = "0.1.0"

__all__ = [
    "Check",
    "CheckLevel",
    "CheckStatus",
    "ColumnarTable",
    "ConstrainableDataTypes",
    "DeviceException",
    "DeviceOOMException",
    "DeviceUnavailableException",
    "DoubleMetric",
    "Entity",
    "HistogramMetric",
    "Metric",
    "NotYetPortedException",
    "VerificationResult",
    "VerificationSuite",
    "use_device",
]
