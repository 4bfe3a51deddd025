"""The ``DEEQU_TORCH_*`` environment-variable registry — one validated
parser for every switch of the port (the counterpart of
``deequ_tpu/envcfg.py``, under the port's own prefix).

- :class:`EnvVar` — one registered variable: name, kind, default,
  constraints and a one-line doc;
- :func:`env_value` — the one parse and validation path. A malformed value
  raises :class:`~deequ_tpu_torch.exceptions.EnvConfigError` (a
  ``ValueError``) naming the variable, the value and what is accepted;
- :func:`registry_snapshot` — {name: {raw, value or error, doc}} for every
  registered variable.

Kinds: ``flag01`` (``'' | '0' | '1'`` strictly), ``int`` and ``float``
(an optional ``minimum``; ``zero_disables`` maps 0 and below to None),
``choice`` and ``str`` (taken as given). Only the switches a ported
module reads are registered; the others come with their modules.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from deequ_tpu_torch.exceptions import EnvConfigError

_KINDS = ("flag01", "int", "float", "choice", "str")


@dataclass(frozen=True)
class EnvVar:
    """One registered DEEQU_TORCH_* variable (module doc for the kinds)."""

    name: str
    kind: str
    default: Any = None
    minimum: Optional[float] = None
    zero_disables: bool = False
    choices: Tuple[str, ...] = ()
    doc: str = ""

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown EnvVar kind {self.kind!r}")
        if self.kind == "choice" and not self.choices:
            raise ValueError(f"{self.name}: choice kind needs choices")


_REGISTRY: Dict[str, EnvVar] = {}


def register(var: EnvVar) -> EnvVar:
    """Add one variable to the registry (idempotent for an identical spec;
    a conflicting re-registration is a programming error)."""
    existing = _REGISTRY.get(var.name)
    if existing is not None and existing != var:
        raise ValueError(f"conflicting registration for {var.name}: {existing} vs {var}")
    _REGISTRY[var.name] = var
    return var


def _parse(var: EnvVar, raw: str) -> Any:
    if var.kind == "flag01":
        if raw not in ("0", "1"):
            raise EnvConfigError(var.name, raw, "'' (default), '0' (off) or '1' (on)")
        return raw != "0"
    if var.kind == "int":
        try:
            val = int(raw)
        except ValueError:
            raise EnvConfigError(var.name, raw, "an integer") from None
        return _bound(var, val)
    if var.kind == "float":
        try:
            val = float(raw)
        except ValueError:
            raise EnvConfigError(var.name, raw, "a number") from None
        return _bound(var, val)
    if var.kind == "str":
        return raw
    if raw not in var.choices:
        raise EnvConfigError(var.name, raw, f"one of {list(var.choices)}")
    return raw


def _bound(var: EnvVar, val):
    if var.zero_disables and val <= 0:
        return None
    if var.minimum is not None and val < var.minimum:
        raise EnvConfigError(var.name, str(val), f"a value >= {var.minimum:g}")
    return val


def env_value(name: str) -> Any:
    """Parse and validate one registered variable from the environment:
    unset or empty gives the registered default, a malformed value raises
    :class:`EnvConfigError`."""
    var = _REGISTRY.get(name)
    if var is None:
        raise KeyError(f"{name} is not a registered DEEQU_TORCH env var")
    raw = os.environ.get(name, "").strip()
    if raw == "":
        return var.default
    return _parse(var, raw)


def registry_snapshot() -> Dict[str, dict]:
    """{name: {raw, value | error, doc, kind}} for every registered
    variable: what this process is configured as."""
    out: Dict[str, dict] = {}
    for name, var in sorted(_REGISTRY.items()):
        row = {"raw": os.environ.get(name), "doc": var.doc, "kind": var.kind}
        try:
            row["value"] = env_value(name)
        except EnvConfigError as e:
            row["error"] = str(e)
        out[name] = row
    return out


# -- the registered variables (one declaration point) ------------------------

ENCODED_INGEST = register(EnvVar(
    "DEEQU_TORCH_ENCODED_INGEST", "flag01", default=True,
    doc="0 packs every column decoded: scans and persist() ignore "
        "dictionary encodings (the A/B switch)",
))
REPO_SEGMENT_ROWS = register(EnvVar(
    "DEEQU_TORCH_REPO_SEGMENT_ROWS", "int", default=4096, minimum=1,
    doc="target scalar-metric rows per compacted columnar-repository "
        "segment (repository/columnar.py)",
))
REPO_TTL = register(EnvVar(
    "DEEQU_TORCH_REPO_TTL", "float", default=None, zero_disables=True,
    doc="retention of the columnar metrics repository in dataset-date "
        "units: compaction drops results older than (newest live date - "
        "TTL); unset or 0 keeps everything",
))
MONITOR = register(EnvVar(
    "DEEQU_TORCH_MONITOR", "flag01", default=True,
    doc="0 disables QualityMonitor observation process-wide (saves are "
        "unaffected; alerts stop)",
))
GROUP_MEMORY_BUDGET = register(EnvVar(
    "DEEQU_TORCH_GROUP_MEMORY_BUDGET", "int", default=None, minimum=1,
    doc="host bytes a grouping's frequency state may hold before it "
        "spills sorted runs to disk (spill/store.py)",
))
DEVICE_DEADLINE = register(EnvVar(
    "DEEQU_TORCH_DEVICE_DEADLINE", "float", default=None, zero_disables=True,
    doc="watchdog deadline (s) on each device call of a scan (a chunk's "
        "step, a fetch); unset or 0 disarms it (ops/device_policy.py)",
))
SHARD_DEADLINE = register(EnvVar(
    "DEEQU_TORCH_SHARD_DEADLINE", "float", default=None, zero_disables=True,
    doc="straggler deadline (s) on each chunk step of a scan over a mesh "
        "of two or more members: a member that stalls past it raises "
        "DeviceHangException (a mesh_straggler event); unset or 0 disarms "
        "it (ops/device_policy.py)",
))
RUN_DEADLINE = register(EnvVar(
    "DEEQU_TORCH_RUN_DEADLINE", "float", default=None, zero_disables=True,
    doc="run-level wall budget (s) for the composed fault ladder "
        "(resilience/governance.py); unset or 0 disables it",
))
RUN_ATTEMPTS = register(EnvVar(
    "DEEQU_TORCH_RUN_ATTEMPTS", "int", default=None, zero_disables=True,
    doc="run-level budget of failure-driven attempts for the composed "
        "fault ladder; unset or 0 disables it",
))
ON_BUDGET_EXHAUSTED = register(EnvVar(
    "DEEQU_TORCH_ON_BUDGET_EXHAUSTED", "choice", default="degrade",
    choices=("degrade", "raise"),
    doc="what an exhausted run budget does: a partial result with exact "
        "unverified row ranges (degrade) or a typed raise",
))
HOST_GROUP_LIMIT = register(EnvVar(
    "DEEQU_TORCH_HOST_GROUP_LIMIT", "int", default=None, minimum=0,
    doc="row count at or below which grouping counts and uniques run on "
        "the host instead of paying a round trip to the card "
        "(ops/segment.py's latency regime); unset = the module default "
        "2^14",
))
PLAN_FUSION = register(EnvVar(
    "DEEQU_TORCH_PLAN_FUSION", "flag01", default=True,
    doc="0 turns off cross-set grouping fusion: every dense grouping set "
        "then counts in its own dispatch (the A/B switch)",
))
HIST_VARIANT = register(EnvVar(
    "DEEQU_TORCH_HIST_VARIANT", "choice", default=None,
    choices=("scatter", "onehot", "pallas"),
    doc="force the histogram kernel variant of every dispatch and plan "
        "(ops/histogram_device.py: onehot is K6, scatter and pallas are K5 "
        "on a card); unset = ops/device_policy.resolve_hist_variant decides",
))
HIST_CPU_CAP = register(EnvVar(
    "DEEQU_TORCH_HIST_CPU_CAP", "int", default=None, minimum=1,
    doc="widest keyspace the one-hot variant takes by default on a CPU "
        "device (unset = the module default 32); also priced by the plan "
        "cost model",
))
HIST_ACCEL_CAP = register(EnvVar(
    "DEEQU_TORCH_HIST_ACCEL_CAP", "int", default=None, minimum=1,
    doc="widest keyspace the one-hot variant (K6) takes by default on a "
        "card (unset = the module default, set from the card's sweep in "
        "PERF.md); also priced by the plan cost model",
))
TRACE = register(EnvVar(
    "DEEQU_TORCH_TRACE", "flag01", default=False,
    doc="1 arms the process-global flight recorder (obs/recorder.py)",
))
TRACE_CAPACITY = register(EnvVar(
    "DEEQU_TORCH_TRACE_CAPACITY", "int", default=None, minimum=1,
    doc="ring capacity (records) of the flight recorder DEEQU_TORCH_TRACE "
        "arms; unset = obs.recorder.DEFAULT_CAPACITY",
))
SERVE_MAX_BATCH = register(EnvVar(
    "DEEQU_TORCH_SERVE_MAX_BATCH", "int", default=64, minimum=1,
    doc="most tenant suites the serving worker takes a batch "
        "(serve/service.py); each plan's share of a take is one coalesced "
        "dispatch",
))
SERVE_COALESCE_WINDOW = register(EnvVar(
    "DEEQU_TORCH_SERVE_COALESCE_WINDOW", "float", default=0.002, minimum=0.0,
    doc="seconds the serving worker waits after a first arrival for "
        "suites to coalesce with",
))
SLO_CLASS = register(EnvVar(
    "DEEQU_TORCH_SLO_CLASS", "choice", default="standard",
    choices=("critical", "standard", "best_effort"),
    doc="SLO class of a submission that carries none (serve/admission.py)",
))
SLO_DEADLINE_MS = register(EnvVar(
    "DEEQU_TORCH_SLO_DEADLINE_MS", "float", default=None, zero_disables=True,
    doc="absolute submit->dispatch deadline (ms) of a submission that "
        "carries no SLO; an expired request is shed typed before dispatch "
        "(unset or 0: no deadline)",
))
BROWNOUT = register(EnvVar(
    "DEEQU_TORCH_BROWNOUT", "flag01", default=True,
    doc="0 turns off the serving brownout ladder (admission-side shedding "
        "by SLO class; computation is never degraded)",
))
FLEET_WORKERS = register(EnvVar(
    "DEEQU_TORCH_FLEET_WORKERS", "int", default=None, minimum=1,
    doc="VerificationFleet worker count (serve/fleet.py; unset = one per "
        "card, at most 4)",
))
HEARTBEAT_INTERVAL = register(EnvVar(
    "DEEQU_TORCH_HEARTBEAT_INTERVAL", "float", default=0.25, minimum=0.005,
    doc="seconds between the fleet membership's liveness probes of its "
        "workers",
))
FAILOVER_RETRIES = register(EnvVar(
    "DEEQU_TORCH_FAILOVER_RETRIES", "int", default=2, minimum=0,
    doc="most worker-loss re-dispatches one accepted request may take "
        "before it rejects typed (WorkerLostException)",
))
FLEET_LEDGER_DIR = register(EnvVar(
    "DEEQU_TORCH_FLEET_LEDGER_DIR", "str", default=None,
    doc="directory of the fleet's durable checksummed request ledger "
        "(serve/ledger.py): accepted work is fsynced at accept, and a fleet "
        "opened on the same directory replays what was not resolved "
        "(unset = no ledger)",
))
