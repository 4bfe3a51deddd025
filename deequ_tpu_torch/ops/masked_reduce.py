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

For the kernel, :func:`group` turns a batch into sources and combos: a
source is a data plane (or a co-moment task's pair) with the masks its
tasks use, and the kernel copies each of its tiles into shared memory
once for all of them; a combo is one (plane, mask set) of a source, whose
fold writes the fields of every task on it. Identical tasks are one.

The kernel's min/max reads NaN as the plain version does (a valid NaN
gives NaN) and orders -0.0 before +0.0, so its result never depends on the
order in which it meets the rows. Its sums and moments associate
otherwise than torch's reductions (the moments are centred on each tile's
mean and moved to the whole mean in the fold): within ``1e-13 · Σ|x|``
(sums) and ``1e-12`` relative (m2 and the co-moments, plus ``n · (128 ulp
· max|x|)^2`` where the centres round apart) of the plain version on the
card, as ``chip_smoke.py``'s ``k1_parity`` holds them. Its bits depend
only on a task's rows and ``n``, never on the pointers' alignment, the
task's place in the batch or the other tasks on its source, so a group
scan stays bit for bit its serial loop.

The kernel is compiled from the source in the checkout at first use and
bound with ``ctypes`` (``ops/cuda_build.py``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from deequ_tpu_torch.exceptions import DeviceException, launch_error
from deequ_tpu_torch.ops import counters, cuda_build

#: calls of :func:`reduce_into` that launched the kernel (each one batch:
#: two launches, the tiles and the fold), and nowhere else (chip_smoke.py
#: reads it around its paths)
LAUNCHES = 0
#: calls of :func:`merge_tags` that launched its kernel
MERGE_LAUNCHES = 0
#: the same launches by the caller named in ``merge_tags(..., caller=)``:
#: ``"fold"`` (a scan's fold) and ``"mesh"`` (K8, ``scan_engine.mesh_merge``)
MERGE_LAUNCHES_BY_CALLER: Dict[str, int] = {}

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

#: a source's caps on masks and combos (csrc/masked_reduce.cu's
#: kSourceMasks and kSourceCombos; the library's ``deequ_k1_geometry``
#: reports them, with its rows a tile and threads a block, and the binding
#: refuses a library whose caps or records differ from these)
SOURCE_MASKS = 7
SOURCE_COMBOS = 16

#: what a combo's fold writes (``enum Field`` in the source)
FIELDS = ("n", "sum", "min", "max", "mean", "m2", "x_avg", "y_avg", "ck", "x_mk", "y_mk")
_FIELD = {name: i for i, name in enumerate(FIELDS)}
#: the planes a combo reads: none (a count), the source's x or y, or both
PLANE_NONE, PLANE_X, PLANE_Y, PLANE_XY = -1, 0, 1, 2
#: the statistics a combo needs beyond its count and sums
FLAG_MIN, FLAG_MAX, FLAG_CENTRED = 1, 2, 4
_FLAGS = {"count": 0, "sum": 0, "min": FLAG_MIN, "max": FLAG_MAX,
          "moments": FLAG_CENTRED, "comoments": FLAG_CENTRED}

#: one source (``struct Source``): its data planes (0: none), its masks
#: (0: none), n, the planes' data types, planes and masks in use, and its
#: combos' range in the combo table
SOURCE_DTYPE = np.dtype({
    "names": ["x", "y", "m", "n", "xtype", "ytype", "nplanes", "nmask", "combo0",
              "ncombo"],
    "formats": ["<u8", "<u8", ("<u8", SOURCE_MASKS), "<i8", "<i4", "<i4", "<i4", "<i4",
                "<i4", "<i4"],
    "offsets": [0, 8, 16, 72, 80, 84, 88, 92, 96, 100],
    "itemsize": 104,
})
#: one combo (``struct Combo``): its source, the source's masks it needs
#: (a bit each), the plane(s) it reads, its flags and its outputs' range
COMBO_DTYPE = np.dtype({
    "names": ["source", "need", "plane", "flags", "out0", "nout"],
    "formats": ["<i4", "<u4", "<i4", "<i4", "<i4", "<i4"],
    "offsets": [0, 4, 8, 12, 16, 20],
    "itemsize": 24,
})
#: one output (``struct Out``): an offset of the flat vector and the field
OUT_DTYPE = np.dtype({
    "names": ["offset", "field"], "formats": ["<i4", "<i4"], "offsets": [0, 4],
    "itemsize": 8,
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
        chunk's row-validity mask, which it builds all-true. The task was
        checked when it was made, so its copy is not checked again."""
        if mask is None or not any(m is mask for m in self.masks):
            return self
        task = Reduction.__new__(Reduction)
        task.kind, task.data, task.n, task.device = self.kind, self.data, self.n, self.device
        task.masks = tuple(m for m in self.masks if m is not mask)
        return task

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
    _check_into(flat, tasks, offsets)
    if flat.device.type == "cpu":
        _reduce_plain_into(flat, tasks, offsets)
        return
    if flat.device.type != "cuda":
        raise ValueError(f"masked_reduce: unsupported device {flat.device}")
    if not tasks:
        return
    _launch_reduce(flat, tasks, offsets)
    counters.inc(globals(), "LAUNCHES")


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
               flat: torch.Tensor, src: Optional[torch.Tensor] = None,
               caller: str = "fold") -> torch.Tensor:
    """:func:`merge_tags_plain`'s function into a new tensor: the kernel
    for CUDA tensors, the plain version for CPU ones; any other device
    raises. A launch counts in ``MERGE_LAUNCHES`` and under ``caller`` in
    ``MERGE_LAUNCHES_BY_CALLER``."""
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
        raise launch_error(f"K1 merge kernel launch failed (n={m})", rc)
    counters.inc(globals(), "MERGE_LAUNCHES")
    counters.inc(globals(), "MERGE_LAUNCHES_BY_CALLER", caller)
    return out


#: the geometry the library reports, in ``deequ_k1_geometry``'s order
GEOMETRY_KEYS = ("tile_rows", "threads", "source_masks", "source_combos",
                 "source_bytes", "combo_bytes", "out_bytes", "part_bytes")
#: bytes of one tile's partial of a combo (``struct Part``)
PART_BYTES = 64


def _bind(lib: ctypes.CDLL) -> None:
    lib.deequ_k1_geometry.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.deequ_k1_geometry.restype = ctypes.c_int
    lib.deequ_k1_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_longlong]
    lib.deequ_k1_scratch_bytes.restype = ctypes.c_longlong
    lib.deequ_k1_reduce.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.deequ_k1_reduce.restype = ctypes.c_int
    lib.deequ_k1_merge.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ]
    lib.deequ_k1_merge.restype = ctypes.c_int
    got = _geometry_of(lib)
    want = {"source_masks": SOURCE_MASKS, "source_combos": SOURCE_COMBOS,
            "source_bytes": SOURCE_DTYPE.itemsize, "combo_bytes": COMBO_DTYPE.itemsize,
            "out_bytes": OUT_DTYPE.itemsize, "part_bytes": PART_BYTES}
    if any(got[k] != v for k, v in want.items()):
        raise DeviceException(f"K1: the library's geometry {got} does not match {want}")
    lib.k1_geometry = got


def _geometry_of(lib: ctypes.CDLL) -> dict:
    buf = (ctypes.c_longlong * len(GEOMETRY_KEYS))()
    if lib.deequ_k1_geometry(buf, len(GEOMETRY_KEYS)) != len(GEOMETRY_KEYS):
        raise DeviceException("K1: deequ_k1_geometry reported another number of values")
    return dict(zip(GEOMETRY_KEYS, (int(v) for v in buf)))


def geometry() -> dict:
    """The built kernel's rows a tile, threads a block, caps a source and
    record sizes (builds the library; a card's machine only)."""
    return dict(cuda_build.library("masked_reduce", _bind).k1_geometry)


# -- the batch as sources and combos ---------------------------------------------


class Batch(NamedTuple):
    """A batch as the kernel reads it: its sources, combos and outputs
    (:data:`SOURCE_DTYPE`, :data:`COMBO_DTYPE`, :data:`OUT_DTYPE`) and the
    most rows of any source."""

    sources: np.ndarray
    combos: np.ndarray
    outs: np.ndarray
    max_n: int


#: the most shared memory a launch asks for to hold two tiles of each
#: one-plane source: two blocks of the kernel still fit an H100's SM
DOUBLE_STAGE_CAP = 100_000


def stage_bytes(batch: Batch, tile_rows: int) -> int:
    """The shared memory a launch of ``batch`` asks for at ``tile_rows``
    rows a tile. A source's tile takes a buffer of its rows for each plane
    (f64 width) and mask, with 16 bytes for the copies' alignment. The
    launch takes its largest tile, or two of its largest one-plane source's
    where that is more and within :data:`DOUBLE_STAGE_CAP`: a source whose
    two tiles fit copies its next tile while it works on one."""
    src = batch.sources
    one = src["nplanes"] * (tile_rows * 8 + 16) + src["nmask"] * (tile_rows + 16)
    largest = int(one.max())
    single = one[src["nplanes"] <= 1]
    twice = 2 * int(single.max()) if single.size else 0
    return max(largest, twice) if twice <= DOUBLE_STAGE_CAP else largest


def _fields(task: Reduction) -> List[int]:
    """The field of each output of ``task``."""
    return [_FIELD[task.kind if name == "value" else name] for name in OUTPUTS[task.kind]]


class _Source:
    """A source being grouped: its planes ((pointer, data type) each), its
    masks (pointers, in the order their bits take) and its combos, keyed by
    (plane, mask set), each [flags, outputs]."""

    __slots__ = ("n", "planes", "masks", "combos")

    def __init__(self, n: int, planes: tuple):
        self.n = n
        self.planes = planes
        self.masks: List[int] = []
        self.combos: dict = {}

    def takes(self, plane: int, masks: frozenset) -> bool:
        return (plane, masks) in self.combos or (
            len(self.combos) < SOURCE_COMBOS
            and len(masks.union(self.masks)) <= SOURCE_MASKS)

    def add(self, plane: int, masks: frozenset, flags: int, outs) -> None:
        combo = self.combos.get((plane, masks))
        if combo is None:
            self.masks.extend(m for m in sorted(masks) if m not in self.masks)
            combo = self.combos[(plane, masks)] = [0, []]
        combo[0] |= flags
        combo[1].extend(outs)


def _place_data(sources: List[_Source], n: int, planes: tuple, masks: frozenset,
                flags: int, outs) -> None:
    """A sum, min, max, moments or co-moments task into the first source
    that reads its plane(s) and has room; else into a new source of them
    (a source past a cap splits: its planes are read by both)."""
    for s in sources:
        if s.n != n:
            continue
        if len(planes) == 2:
            plane = PLANE_XY if s.planes == planes else None
        else:
            plane = s.planes.index(planes[0]) if planes[0] in s.planes else None
        if plane is not None and s.takes(plane, masks):
            s.add(plane, masks, flags, outs)
            return
    s = _Source(n, planes)
    sources.append(s)
    s.add(PLANE_XY if len(planes) == 2 else PLANE_X, masks, flags, outs)


def _place_count(sources: List[_Source], n: int, masks: frozenset, outs) -> None:
    """A count: the ``n`` output of a combo with its very mask set where
    one exists; else a count-only combo in a source that reads all its
    masks already; else in a source of masks alone."""
    same = [s for s in sources if s.n == n]
    for s in same:
        for plane, ms in s.combos:
            if ms == masks:
                s.add(plane, masks, 0, outs)
                return
    for s in same:
        if masks.issubset(s.masks) and s.takes(PLANE_NONE, masks):
            s.add(PLANE_NONE, masks, 0, outs)
            return
    for s in same:
        if not s.planes and s.takes(PLANE_NONE, masks):
            s.add(PLANE_NONE, masks, 0, outs)
            return
    s = _Source(n, ())
    sources.append(s)
    s.add(PLANE_NONE, masks, 0, outs)


def group(tasks: Sequence[Reduction], offsets: Sequence[Sequence[int]]) -> Batch:
    """The batch as sources and combos.

    Identical tasks (kind, tensors by pointer, mask set) are one. A source
    is one data plane, or a co-moment task's pair, with the masks its
    tasks use; a task on one plane of a pair joins the pair's source.
    Within a source a combo is one (plane, mask set): each task maps to
    fields of a combo, whose fold writes them at every offset of every
    task on it. A count takes the count of a combo of its mask set, or
    joins a source that reads its masks, or a source of masks alone. A
    source holds at most :data:`SOURCE_MASKS` masks and
    :data:`SOURCE_COMBOS` combos. Tasks are placed in an order of their
    own (co-moments, other data tasks, counts; then by rows and
    pointers), so the batch's order changes no source."""
    merged: dict = {}
    for task, offs in zip(tasks, offsets):
        data = tuple((d.data_ptr(), _DTYPES[d.dtype]) for d in task.data)
        key = (task.n, task.kind, data, tuple(sorted({m.data_ptr() for m in task.masks})))
        merged.setdefault(key, []).extend(
            (off, field) for off, field in zip(offs, _fields(task)) if off >= 0)
    rank = {"comoments": 0, "count": 2}
    sources: List[_Source] = []
    for key in sorted(merged, key=lambda k: (rank.get(k[1], 1), k[0], k[2], k[3], k[1])):
        n, kind, data, masks = key
        if kind == "count":
            _place_count(sources, n, frozenset(masks), merged[key])
        else:
            _place_data(sources, n, data, frozenset(masks), _FLAGS[kind], merged[key])
    src_rows, combo_rows, out_rows = [], [], []
    for i, s in enumerate(sources):
        planes = list(s.planes) + [(0, 0)] * (2 - len(s.planes))
        src_rows.append((planes[0][0], planes[1][0], s.masks + [0] * (SOURCE_MASKS - len(s.masks)),
                         s.n, planes[0][1], planes[1][1], len(s.planes), len(s.masks),
                         len(combo_rows), len(s.combos)))
        for (plane, masks), (flags, outs) in s.combos.items():
            need = sum(1 << s.masks.index(m) for m in masks)
            combo_rows.append((i, need, plane, flags, len(out_rows), len(outs)))
            out_rows.extend(outs)
    return Batch(
        np.array(src_rows, dtype=SOURCE_DTYPE), np.array(combo_rows, dtype=COMBO_DTYPE),
        np.array(out_rows, dtype=OUT_DTYPE),
        max(s.n for s in sources),
    )


def _launch_reduce(flat, tasks, offsets) -> None:
    """Enqueue the batch on the current stream: its tables go to the card
    by one non-blocking copy from pinned memory (torch's host allocator
    keeps that block until the copy has run), the tiles' partials are
    allocated here. Raises if a launch was refused."""
    for task in tasks:
        for t in task.data + task.masks:
            if not t.is_contiguous():
                raise ValueError("masked_reduce: a task's tensors must be contiguous")
            if t.data_ptr() % t.element_size():
                raise ValueError("masked_reduce: a task's tensors must be aligned to their type")
    batch = group(tasks, offsets)
    blob = np.concatenate([batch.sources.view(np.uint8), batch.combos.view(np.uint8),
                           batch.outs.view(np.uint8)])
    lib = cuda_build.library("masked_reduce", _bind)
    device = flat.device
    with torch.cuda.device(device):
        staged = torch.empty(blob.nbytes, dtype=torch.uint8, pin_memory=True)
        staged.numpy()[:] = blob
        desc = staged.to(device, non_blocking=True)
        scratch = torch.empty(
            int(lib.deequ_k1_scratch_bytes(len(batch.combos), batch.max_n)),
            dtype=torch.uint8, device=device,
        )
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.deequ_k1_reduce(
            desc.data_ptr(), len(batch.sources), len(batch.combos), len(batch.outs),
            batch.max_n, stage_bytes(batch, lib.k1_geometry["tile_rows"]), scratch.data_ptr(),
            flat.data_ptr(), stream,
        )
    if rc != 0:
        raise launch_error(
            f"K1 kernel launch failed ({len(tasks)} tasks, {len(batch.sources)} sources, "
            f"{len(batch.combos)} combos, n={batch.max_n})", rc,
        )
