"""K1, the fused scan's per-chunk masked reductions — the port's counterpart
of ``deequ_tpu/ops/df32.py`` (``masked_count``, ``masked_sum``,
``masked_extremum``, ``masked_moments``, ``masked_comoments`` and
``merge_tags_f64``).

The reference computes these over (hi, lo) f32 pairs with TwoSum
compensation, because the TPU has no f64 units. The H100 has native f64,
so the port reads and accumulates every row in f64 and keeps none of the
pair machinery (no ``split_pair_np``, no TwoSum, no tree of halvings).

Three layers:

- the plain versions (:func:`masked_count` ... :func:`masked_comoments`,
  :func:`merge_tags_plain`) in torch f64: the CPU's route, and what the
  tests and ``chip_smoke.py`` hold the kernel against;
- :class:`Reduction`, one task of K1: its kind (count, sum, min, max,
  moments, comoments), one data tensor or two (f64; string lengths may
  come as int32), up to three bool masks that hold together (none: every
  row), and its row count ``n``. A ``ScanOp.update`` returns tasks (or
  :meth:`Reduction.__getitem__` outputs of a multi-output task) as leaves
  beside tensor leaves; the scan engine (``ops/scan_engine.py``) gathers a
  chunk's tasks and resolves them at once. No placeholder tensor is handed
  back to an op: the engine, not the op, puts the results in place;
- :func:`reduce_into`, the wrapper: for a CUDA tensor it launches the
  hand-written kernel of ``deequ_tpu_torch/csrc/masked_reduce.cu`` over the
  whole batch, which writes each output as f64 at its offset of the chunk's
  flat state vector; for a CPU tensor it runs the plain versions and
  writes their results there, bit for bit what the scan wrote before K1
  had a kernel; any other device raises. :func:`merge_tags` is the same
  for the tagged fold of a chunk's vector into the scan's accumulator.

The kernel's min/max reads NaN as the plain version does (a valid NaN
gives NaN) and orders -0.0 before +0.0, so its result never depends on the
order in which it meets the rows. Its sums and moments associate
otherwise than torch's reductions: within ``1e-13 · Σ|x|`` (sums) and
``1e-12`` relative (m2 and the co-moments, plus ``n · (128 ulp ·
max|x|)^2`` where the two means round apart) of the plain version on
the card, as ``chip_smoke.py``'s ``k1_parity`` holds them. Its bits depend
only on a task's rows and ``n``, never on the pointers' alignment, the
task's place in the batch or the other tasks, so a group scan stays bit
for bit its serial loop.

The kernel is compiled from the source in the checkout at first use and
bound with ``ctypes`` (``ops/cuda_build.py``).
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from deequ_tpu_torch.exceptions import DeviceException
from deequ_tpu_torch.ops import cuda_build

#: calls of :func:`reduce_into` that launched the kernel (each one batch:
#: two launches, four where the batch holds a moment task), and nowhere
#: else (chip_smoke.py reads it around its paths)
LAUNCHES = 0
#: calls of :func:`merge_tags` that launched its kernel
MERGE_LAUNCHES = 0

#: task kinds, in the source's numbering, and the outputs of each
KINDS = ("count", "sum", "min", "max", "moments", "comoments")
OUTPUTS = {
    "count": ("n",),
    "sum": ("sum",),
    "min": ("value",),
    "max": ("value",),
    "moments": ("n", "mean", "m2"),
    "comoments": ("n", "x_avg", "y_avg", "ck", "x_mk", "y_mk"),
}
_DATA = {"count": 0, "sum": 1, "min": 1, "max": 1, "moments": 1, "comoments": 2}
#: the data types a task reads, in the source's numbering
_DTYPES = {torch.float64: 0, torch.int32: 1}
MAX_MASKS = 3

#: one task of the kernel's descriptor table (``struct Task`` in
#: csrc/masked_reduce.cu): data pointers, mask pointers (0: none), n,
#: kind, data types, masks in use and each output's offset (-1: none)
TASK_DTYPE = np.dtype({
    "names": ["x", "y", "m", "n", "kind", "xtype", "ytype", "nmask", "out"],
    "formats": ["<u8", "<u8", ("<u8", MAX_MASKS), "<i8", "<i4", "<i4", "<i4", "<i4",
                ("<i4", 6)],
    "offsets": [0, 8, 16, 40, 48, 52, 56, 60, 64],
    "itemsize": 88,
})


# -- the plain versions (f64 counterparts of df32.py) -------------------------


def masked_count(ok: torch.Tensor) -> torch.Tensor:
    return ok.sum(dtype=torch.int64)


def masked_sum(x: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    return torch.where(ok, x, 0.0).sum()


def masked_extremum(x: torch.Tensor, ok: torch.Tensor, mode: str) -> torch.Tensor:
    """Min/max of x where ok; the identity (+inf / -inf) when nothing is
    valid — callers guard on the separate count."""
    ident = np.inf if mode == "min" else -np.inf
    if x.numel() == 0:
        return torch.tensor(ident, dtype=torch.float64, device=x.device)
    guarded = torch.where(ok, x, ident)
    return guarded.amin() if mode == "min" else guarded.amax()


def masked_moments(x: torch.Tensor, ok: torch.Tensor):
    """(count, mean, m2) of x where ok — the chunk's Welford state, with
    m2 a centred two-pass sum (reference df32.masked_moments)."""
    cnt = masked_count(ok)
    mean = masked_sum(x, ok) / cnt.clamp(min=1)
    d = torch.where(ok, x - mean, 0.0)
    return cnt, mean, (d * d).sum()


def masked_comoments(a: torch.Tensor, b: torch.Tensor, ok: torch.Tensor):
    """(n, x_avg, y_avg, ck, x_mk, y_mk) chunk co-moment state
    (reference df32.masked_comoments, Correlation.scala:37-52)."""
    cnt = masked_count(ok)
    denom = cnt.clamp(min=1)
    ma = masked_sum(a, ok) / denom
    mb = masked_sum(b, ok) / denom
    da = torch.where(ok, a - ma, 0.0)
    db = torch.where(ok, b - mb, 0.0)
    return cnt, ma, mb, (da * db).sum(), (da * da).sum(), (db * db).sum()


def merge_tags_plain(is_sum: torch.Tensor, is_min: torch.Tensor, acc: torch.Tensor,
                     flat: torch.Tensor, src: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Elementwise tagged merge of a state vector ``acc`` with the entries
    ``flat[src]`` of a chunk's flat vector (all of ``flat`` when ``src`` is
    None): add where ``is_sum``, minimum where ``is_min``, maximum
    elsewhere; min/max propagate NaN (reference df32.merge_tags_f64)."""
    new = flat if src is None else flat[src]
    return torch.where(
        is_sum,
        acc + new,
        torch.where(is_min, torch.minimum(acc, new), torch.maximum(acc, new)),
    )


# -- tasks ------------------------------------------------------------------


class Output(NamedTuple):
    """Output ``index`` of a multi-output task, as a scan leaf."""

    task: "Reduction"
    index: int


class Reduction:
    """One masked reduction of one chunk: a task of K1.

    ``kind`` is one of :data:`KINDS`; ``data`` holds no tensor (count),
    two (comoments) or one, each 1-D float64 or int32; ``masks`` holds at
    most :data:`MAX_MASKS` 1-D bool tensors, all of which must hold for a
    row to count (an empty tuple: every row). A mask passed twice counts
    once. ``n`` is the rows (the tensors' length) and ``device`` their
    device; both are given for a count with no tensor at all."""

    __slots__ = ("kind", "data", "masks", "n", "device")

    def __init__(self, kind: str, data: Sequence[torch.Tensor] = (),
                 masks: Sequence[Optional[torch.Tensor]] = (), n: Optional[int] = None,
                 device=None):
        if kind not in KINDS:
            raise ValueError(f"masked_reduce: unknown kind {kind!r}")
        data = tuple(data)
        if len(data) != _DATA[kind]:
            raise ValueError(f"masked_reduce: {kind} takes {_DATA[kind]} data tensors")
        uniq: List[torch.Tensor] = []
        for m in masks:
            if m is not None and not any(m is u for u in uniq):
                uniq.append(m)
        if len(uniq) > MAX_MASKS:
            raise ValueError(f"masked_reduce: at most {MAX_MASKS} masks a task")
        for t in data:
            if not isinstance(t, torch.Tensor) or t.dim() != 1 or t.dtype not in _DTYPES:
                raise TypeError("masked_reduce: data must be 1-D float64 or int32 tensors")
        for m in uniq:
            if not isinstance(m, torch.Tensor) or m.dim() != 1 or m.dtype != torch.bool:
                raise TypeError("masked_reduce: masks must be 1-D bool tensors")
        tensors = data + tuple(uniq)
        if not tensors and n is None:
            raise ValueError("masked_reduce: a task with no tensor needs n")
        if tensors:
            n = tensors[0].shape[0] if n is None else n
            device = tensors[0].device
        if any(t.shape[0] != n for t in tensors) or n < 0:
            raise ValueError("masked_reduce: a task's tensors must all have n rows")
        if any(t.device != device for t in tensors):
            raise ValueError("masked_reduce: a task's tensors must share one device")
        self.kind = kind
        self.data = data
        self.masks = tuple(uniq)
        self.n = int(n)
        self.device = torch.device("cpu" if device is None else device)

    def __getitem__(self, index: int) -> Output:
        if not 0 <= index < len(OUTPUTS[self.kind]):
            raise IndexError(f"masked_reduce: {self.kind} has {len(OUTPUTS[self.kind])} outputs")
        return Output(self, index)

    @property
    def n_outputs(self) -> int:
        return len(OUTPUTS[self.kind])

    def is_int(self, index: int) -> bool:
        """Whether output ``index`` is an integer (a count)."""
        return OUTPUTS[self.kind][index] == "n"

    def without(self, mask: Optional[torch.Tensor]) -> "Reduction":
        """This task less ``mask`` (by identity): the engine drops its
        chunk's row-validity mask, which it builds all-true."""
        if mask is None or not any(m is mask for m in self.masks):
            return self
        return Reduction(self.kind, self.data, [m for m in self.masks if m is not mask],
                         self.n, self.device)

    def plain(self) -> Tuple[torch.Tensor, ...]:
        """The task's outputs by the plain versions, one tensor each."""
        ok = None
        for m in self.masks:
            ok = m if ok is None else ok & m
        if ok is None:
            ok = torch.ones(self.n, dtype=torch.bool, device=self.device)
        data = [x if x.dtype == torch.float64 else x.to(torch.float64) for x in self.data]
        if self.kind == "count":
            return (masked_count(ok),)
        if self.kind == "sum":
            return (masked_sum(data[0], ok),)
        if self.kind in ("min", "max"):
            return (masked_extremum(data[0], ok, self.kind),)
        if self.kind == "moments":
            return tuple(masked_moments(data[0], ok))
        return tuple(masked_comoments(data[0], data[1], ok))


def count(*masks: Optional[torch.Tensor], n: Optional[int] = None, device=None) -> Reduction:
    return Reduction("count", (), masks, n, device)


def total(x: torch.Tensor, *masks: Optional[torch.Tensor]) -> Reduction:
    return Reduction("sum", (x,), masks)


def extremum(x: torch.Tensor, mode: str, *masks: Optional[torch.Tensor]) -> Reduction:
    if mode not in ("min", "max"):
        raise ValueError(f"masked_reduce: extremum mode must be min or max, got {mode!r}")
    return Reduction(mode, (x,), masks)


def moments(x: torch.Tensor, *masks: Optional[torch.Tensor]) -> Reduction:
    return Reduction("moments", (x,), masks)


def comoments(a: torch.Tensor, b: torch.Tensor, *masks: Optional[torch.Tensor]) -> Reduction:
    return Reduction("comoments", (a, b), masks)


def outputs_of(leaf) -> Optional[List[Output]]:
    """The task outputs a scan leaf stands for, in order (a 1-D vector for
    a list or tuple of them), or None for a tensor leaf."""
    if isinstance(leaf, torch.Tensor):
        return None
    if isinstance(leaf, Reduction):
        if leaf.n_outputs != 1:
            raise ValueError(f"masked_reduce: a {leaf.kind} task is a leaf only by its outputs")
        return [Output(leaf, 0)]
    if isinstance(leaf, Output):
        return [leaf]
    if isinstance(leaf, (list, tuple)) and leaf:
        out: List[Output] = []
        for item in leaf:
            got = outputs_of(item)
            if got is None:
                raise TypeError("masked_reduce: a vector leaf holds task outputs only")
            out.extend(got)
        return out
    raise TypeError(f"masked_reduce: a scan leaf must be a tensor or task outputs, got {leaf!r}")


# -- the wrappers ---------------------------------------------------------------


def _check_into(flat: torch.Tensor, tasks, offsets) -> None:
    if not isinstance(flat, torch.Tensor) or flat.dtype != torch.float64 or flat.dim() != 1:
        raise ValueError("masked_reduce: flat must be a 1-D float64 tensor")
    if len(tasks) != len(offsets):
        raise ValueError("masked_reduce: one offset tuple a task")
    size = flat.numel()
    for task, offs in zip(tasks, offsets):
        if not isinstance(task, Reduction):
            raise TypeError("masked_reduce: tasks must be Reductions")
        if len(offs) != task.n_outputs or any(not -1 <= o < size for o in offs):
            raise ValueError("masked_reduce: an offset a task output, -1 or inside flat")
        if task.device != flat.device:
            raise ValueError("masked_reduce: a task lies on another device than flat")


def reduce_into(flat: torch.Tensor, tasks: Sequence[Reduction],
                offsets: Sequence[Sequence[int]]) -> None:
    """Write output i of each task, as f64, at ``flat[offsets[t][i]]``
    (-1: not written). A CUDA ``flat`` launches the kernel over the whole
    batch; a CPU one runs the plain versions; any other device raises."""
    global LAUNCHES
    _check_into(flat, tasks, offsets)
    if flat.device.type == "cpu":
        _reduce_plain_into(flat, tasks, offsets)
        return
    if flat.device.type != "cuda":
        raise ValueError(f"masked_reduce: unsupported device {flat.device}")
    if not tasks:
        return
    _launch_reduce(flat, tasks, offsets)
    LAUNCHES += 1


def _reduce_plain_into(flat, tasks, offsets) -> None:
    idx: List[int] = []
    vals: List[torch.Tensor] = []
    for task, offs in zip(tasks, offsets):
        for off, value in zip(offs, task.plain()):
            if off >= 0:
                idx.append(off)
                vals.append(value.to(torch.float64).reshape(()))
    if idx:
        flat[torch.tensor(idx, dtype=torch.int64, device=flat.device)] = torch.stack(vals)


def merge_tags(is_sum: torch.Tensor, is_min: torch.Tensor, acc: torch.Tensor,
               flat: torch.Tensor, src: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`merge_tags_plain`'s function into a new tensor: the kernel
    for CUDA tensors, the plain version for CPU ones; any other device
    raises."""
    global MERGE_LAUNCHES
    m = acc.numel()
    for t, dt in ((is_sum, torch.bool), (is_min, torch.bool), (acc, torch.float64),
                  (flat, torch.float64)):
        if not isinstance(t, torch.Tensor) or t.dtype != dt or t.dim() != 1:
            raise ValueError("merge_tags: is_sum/is_min bool, acc/flat float64, all 1-D")
    if is_sum.numel() != m or is_min.numel() != m:
        raise ValueError("merge_tags: is_sum, is_min and acc must have one size")
    if src is None:
        if flat.numel() != m:
            raise ValueError("merge_tags: flat must have acc's size when src is None")
    elif src.dtype != torch.int64 or src.dim() != 1 or src.numel() != m:
        raise ValueError("merge_tags: src must be a 1-D int64 tensor of acc's size")
    tensors = [is_sum, is_min, acc, flat] + ([] if src is None else [src])
    if any(t.device != acc.device for t in tensors):
        raise ValueError("merge_tags: every tensor must lie on one device")
    if acc.device.type == "cpu":
        return merge_tags_plain(is_sum, is_min, acc, flat, src)
    if acc.device.type != "cuda":
        raise ValueError(f"merge_tags: unsupported device {acc.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("merge_tags: every tensor must be contiguous")
    out = torch.empty_like(acc)
    if m == 0:
        return out
    lib = cuda_build.library("masked_reduce", _bind)
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        rc = lib.deequ_k1_merge(
            is_sum.data_ptr(), is_min.data_ptr(), acc.data_ptr(), flat.data_ptr(),
            None if src is None else src.data_ptr(), out.data_ptr(), m, stream,
        )
    if rc != 0:
        raise DeviceException(f"K1 merge kernel launch failed: CUDA error {rc} (n={m})")
    MERGE_LAUNCHES += 1
    return out


def _bind(lib: ctypes.CDLL) -> None:
    lib.deequ_k1_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
    lib.deequ_k1_scratch_bytes.restype = ctypes.c_longlong
    lib.deequ_k1_reduce.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.deequ_k1_reduce.restype = ctypes.c_int
    lib.deequ_k1_merge.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ]
    lib.deequ_k1_merge.restype = ctypes.c_int


def describe(tasks: Sequence[Reduction], offsets: Sequence[Sequence[int]]):
    """The kernel's descriptor table of a batch (:data:`TASK_DTYPE`, one
    record a task) and the indices of its moment and co-moment tasks
    (int32), which the kernel's centred pass walks."""
    T = len(tasks)
    table = np.zeros(T, dtype=TASK_DTYPE)
    cols = {"x": [], "y": [], "m": [], "n": [], "kind": [], "xtype": [], "ytype": [],
            "nmask": [], "out": []}
    for task, offs in zip(tasks, offsets):
        data = list(task.data) + [None] * (2 - len(task.data))
        masks = list(task.masks) + [None] * (MAX_MASKS - len(task.masks))
        cols["x"].append(0 if data[0] is None else data[0].data_ptr())
        cols["y"].append(0 if data[1] is None else data[1].data_ptr())
        cols["m"].append([0 if m is None else m.data_ptr() for m in masks])
        cols["n"].append(task.n)
        cols["kind"].append(KINDS.index(task.kind))
        cols["xtype"].append(0 if data[0] is None else _DTYPES[data[0].dtype])
        cols["ytype"].append(0 if data[1] is None else _DTYPES[data[1].dtype])
        cols["nmask"].append(len(task.masks))
        cols["out"].append(list(offs) + [-1] * (6 - len(offs)))
    for name, values in cols.items():
        table[name] = np.asarray(values, dtype=table.dtype[name].base).reshape(
            table[name].shape)
    moment_ids = np.array([i for i, t in enumerate(tasks)
                           if t.kind in ("moments", "comoments")], dtype=np.int32)
    return table, moment_ids


def _launch_reduce(flat, tasks, offsets) -> None:
    """Enqueue the batch on the current stream: the descriptor table goes
    to the card by a non-blocking copy from pinned memory (torch's host
    allocator keeps that block until the copy has run), the scratch is
    allocated here. Raises if a launch was refused."""
    for task in tasks:
        if not all(t.is_contiguous() for t in task.data + task.masks):
            raise ValueError("masked_reduce: a task's tensors must be contiguous")
    table, moment_ids = describe(tasks, offsets)
    head = table.nbytes
    blob = np.zeros(head + moment_ids.nbytes, dtype=np.uint8)
    blob[:head] = table.view(np.uint8)
    blob[head:] = moment_ids.view(np.uint8)
    max_n = max(t.n for t in tasks)
    lib = cuda_build.library("masked_reduce", _bind)
    device = flat.device
    with torch.cuda.device(device):
        staged = torch.empty(blob.nbytes, dtype=torch.uint8, pin_memory=True)
        staged.numpy()[:] = blob
        desc = staged.to(device, non_blocking=True)
        scratch = torch.empty(
            int(lib.deequ_k1_scratch_bytes(len(tasks), len(moment_ids), max_n)),
            dtype=torch.uint8, device=device,
        )
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.deequ_k1_reduce(
            desc.data_ptr(), len(tasks), desc.data_ptr() + head, len(moment_ids), max_n,
            scratch.data_ptr(), flat.data_ptr(), stream,
        )
    if rc != 0:
        raise DeviceException(
            f"K1 kernel launch failed: CUDA error {rc} ({len(tasks)} tasks, n={max_n})"
        )
