"""Hand-written CUDA kernels for Hopper (sm_90a), one wrapper module per
kernel, mirroring the JAX package's ``ops/pallas/``:

- ``paged_decode``        <- ops/pallas/paged_decode.py::pallas_paged_decode
- ``flash_prefill``       <- ops/pallas/flash_prefill.py::flash_ragged_prefill
- ``flash_prefill_hist``  <- ops/pallas/flash_prefill_hist.py::flash_prefill_history
- ``int4_matmul``         <- ops/pallas/int4_matmul.py::pallas_int4_matmul
- ``spec_verify``         <- no TPU kernel: the JAX package's XLA
  ``ops/attention.py::spec_verify_attention_xla``, which a captured verify
  program needs over its whole page table
- ``graph_gate``          <- no TPU kernel: the CUDA-graph conditional
  nodes by which a captured program skips a stage, as the JAX programs'
  ``lax.cond`` does (``ops/gates.py``); it launches no counted kernel

Each wrapper validates its inputs, allocates the output, launches on
PyTorch's current stream (a capture stream while the engine captures a
step program), raises on a launch error, and counts its launches with
``note_launch``: in a plain module-level integer ``launches`` and in its
thread's open tally. A replayed CUDA graph launches the kernels it
recorded without calling the wrappers: the engine's program cache
(``engine/step_programs.py``) tallies what a capture recorded on its own
thread (``tally_launches``; engines of one process step in threads of
their own), takes those counts back (a capture launches nothing) and adds
them at every replay. A split kernel's workspace and counters come from
its ``Scratch``: one set per stream, and one per capture opened with
``capture_scratch``, so calls that can run at once share none. A wrapper accepts CUDA tensors only: the plain
PyTorch versions for the CPU live in ``ops/attention.py`` and
``ops/quant.py``, whose dispatchers choose by device.
"""

from __future__ import annotations

import contextlib
import importlib
import threading

import torch

_tally = threading.local()


def _wrapper(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def note_launch(kernel: str) -> None:
    """One launch of ``kernel``: counted in its wrapper's ``launches`` and
    in this thread's open tally. A wrapper calls it where it launches its
    kernel, and nowhere else."""
    _wrapper(kernel).launches += 1
    counts = getattr(_tally, "counts", None)
    if counts is not None:
        counts[kernel] = counts.get(kernel, 0) + 1


@contextlib.contextmanager
def tally_launches():
    """This thread's launches while open, by kernel: what a capture
    recorded, whatever other threads launch meanwhile (a snapshot of the
    global counts would take theirs too, or lose them)."""
    outer = getattr(_tally, "counts", None)
    _tally.counts = counts = {}
    try:
        yield counts
    finally:
        _tally.counts = outer


def add_launches(counts: dict[str, int]) -> None:
    """Launches added to each kernel's count (a replay's; negative to take
    a capture's back)."""
    for name, n in counts.items():
        _wrapper(name).launches += n


_capture = threading.local()


@contextlib.contextmanager
def capture_scratch():
    """Open around a CUDA graph capture on this thread: every kernel's
    workspace and counters that the capture takes are allocated in it (its
    counters zeroed by the graph at each replay), for this graph alone.
    Yields the tensors, which the caller keeps alive as long as the
    graph."""
    outer = getattr(_capture, "sets", None)
    _capture.sets = sets = _Sets()
    try:
        yield sets
    finally:
        _capture.sets = outer


class _Sets(dict):
    """key -> (workspace, counters), and every set outgrown: a graph
    captured while it was current may still point at it."""

    def __init__(self):
        super().__init__()
        self.retired: list[torch.Tensor] = []


class Scratch:
    """A split kernel's fp32 workspace and int32 counters (all 0 between
    calls; the kernel leaves them so). Two calls that can run at once never
    share a set: outside a capture each CUDA stream has its own (an
    engine's capture warm-up runs on its side stream while other engines'
    threads launch on the default one), and a capture opened with
    ``capture_scratch`` has its own. A capture without one uses its
    stream's set, or, where that set must be made or grown, a set of the
    call's own, kept for the life of the process. A set grows to the
    largest call it has served."""

    def __init__(self):
        self._sets = _Sets()       # (device index, stream) -> set
        self._kept: list[torch.Tensor] = []

    def pointers(self, dev: int, stream: int, ws_floats: int,
                 n_counters: int) -> tuple[int, int]:
        """(workspace, counters) addresses for a call on ``stream``."""
        sets, key = getattr(_capture, "sets", None), (id(self), dev)
        if sets is None:
            sets, key = self._sets, (dev, stream)
        ws, cnt = sets.get(key, (None, None))
        if ws is None or ws.numel() < ws_floats or cnt.numel() < n_counters:
            if sets is self._sets and torch.cuda.is_current_stream_capturing():
                # Counters made here are zeroed only when the graph runs.
                ws, cnt = self._new(dev, ws_floats, n_counters)
                self._kept += [ws, cnt]
                return ws.data_ptr(), cnt.data_ptr()
            if ws is not None:
                sets.retired += [ws, cnt]
                ws_floats = max(ws_floats, ws.numel())
                n_counters = max(n_counters, cnt.numel())
            ws, cnt = sets[key] = self._new(dev, ws_floats, n_counters)
        return ws.data_ptr(), cnt.data_ptr()

    @staticmethod
    def _new(dev: int, ws_floats: int, n_counters: int) -> tuple:
        device = torch.device("cuda", dev)
        return (torch.empty(max(ws_floats, 1), dtype=torch.float32,
                            device=device),
                torch.zeros(max(n_counters, 1), dtype=torch.int32,
                            device=device))

    def counters_in_use(self) -> int:
        """Counters outside a capture that are not 0 (each is left 0 by
        the kernel: any other value is a fault). Synchronizes."""
        return sum(int(cnt.count_nonzero()) for _, cnt in self._sets.values())

    def clear(self) -> None:
        """Forget the per-stream sets (a fresh start for a tool; graphs
        captured with them must be gone)."""
        self._sets = _Sets()


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
PAGE_SIZES = (8, 16, 32, 64, 128)
HEAD_DIMS = (64, 128)
MAX_GROUP = 16


def check_tensors(kernel: str, dtype_args: dict, int_args: dict):
    """Validate device, dtype and contiguity of a kernel's arguments; returns
    the dtype code of the floating inputs. ``dtype_args`` must share one
    dtype in DTYPE_CODES; ``int_args`` must be int32."""
    tensors = {**dtype_args, **int_args}
    first = next(iter(dtype_args.values()))
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{kernel}: {name} is on {t.device}; the kernel "
                             "takes CUDA tensors only")
        if t.device != first.device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, "
                             f"expected {first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
    dtype = first.dtype
    if dtype not in DTYPE_CODES:
        raise ValueError(f"{kernel}: dtype {dtype} not supported "
                         f"(one of {list(DTYPE_CODES)})")
    for name, t in dtype_args.items():
        if t.dtype != dtype:
            raise ValueError(f"{kernel}: {name} is {t.dtype}, expected {dtype}")
    for name, t in int_args.items():
        if t.dtype != torch.int32:
            raise ValueError(f"{kernel}: {name} must be int32, got {t.dtype}")
    return DTYPE_CODES[dtype]


def check_geometry(kernel: str, nh: int, n_kv: int, hd: int,
                   ps: int | None = None) -> None:
    if hd not in HEAD_DIMS:
        raise ValueError(f"{kernel}: head_dim {hd} not supported "
                         f"(one of {HEAD_DIMS})")
    if ps is not None and ps not in PAGE_SIZES:
        raise ValueError(f"{kernel}: page_size {ps} not supported "
                         f"(one of {PAGE_SIZES})")
    if n_kv <= 0 or nh % n_kv:
        raise ValueError(f"{kernel}: {nh} query heads not a multiple of "
                         f"{n_kv} kv heads")
    if nh // n_kv > MAX_GROUP:
        raise ValueError(f"{kernel}: {nh // n_kv} query heads per kv head "
                         f"exceeds {MAX_GROUP}")


def pool_layers(pool: torch.Tensor) -> tuple[int, int, tuple]:
    """(L, bytes between two layers, one layer's shape) of a stacked pool
    [L, P, ps, n_kv*hd]; (0, 0, its shape) for a one-layer pool."""
    if pool.dim() == 4:
        return (pool.shape[0], pool.stride(0) * pool.element_size(),
                tuple(pool.shape[1:]))
    return 0, 0, tuple(pool.shape)


def layer_offset(kernel: str, layers: int, layer_bytes: int,
                 layer: int | None) -> int:
    """Byte offset of ``layer`` in a stacked pool of ``layers`` layers (0
    for a one-layer pool): kernels take one layer's base pointer, so no
    view is made per call."""
    if not layers:
        return 0
    if layer is None or not 0 <= layer < layers:
        raise ValueError(f"{kernel}: layer {layer} of a stacked pool of "
                         f"{layers} layers")
    return layer * layer_bytes


def device_of(kernel: str, tensors: tuple) -> int:
    """The index of the one CUDA device on which every tensor lies, each
    contiguous: the per-call checks of a launch whose shapes and dtypes
    were checked when its key was first seen. Raises ValueError otherwise."""
    dev = tensors[0].get_device()
    if dev >= 0 and all(t.get_device() == dev and t.is_contiguous()
                        for t in tensors):
        return dev
    got = ", ".join(f"{t.device}{'' if t.is_contiguous() else ' strided'}"
                    for t in tensors)
    raise ValueError(f"{kernel}: the kernel takes contiguous CUDA tensors "
                     f"on one device only, got {got}")


if hasattr(torch._C, "_cuda_getCurrentRawStream"):
    raw_stream = torch._C._cuda_getCurrentRawStream
else:                               # builds without the private accessor
    def raw_stream(index: int) -> int:
        return torch.cuda.current_stream(index).cuda_stream
