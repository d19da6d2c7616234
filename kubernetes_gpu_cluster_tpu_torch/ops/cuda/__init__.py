"""Hand-written CUDA kernels for Hopper (sm_90a), one wrapper module per
kernel, mirroring the JAX package's ``ops/pallas/``:

- ``paged_decode``        <- ops/pallas/paged_decode.py::pallas_paged_decode
- ``flash_prefill``       <- ops/pallas/flash_prefill.py::flash_ragged_prefill
- ``flash_prefill_hist``  <- ops/pallas/flash_prefill_hist.py::flash_prefill_history
- ``int4_matmul``         <- ops/pallas/int4_matmul.py::pallas_int4_matmul
- ``spec_verify``         <- no TPU kernel: the JAX package's XLA
  ``ops/attention.py::spec_verify_attention_xla``, which a captured verify
  program needs over its whole page table

Each wrapper validates its inputs, allocates the output, launches on
PyTorch's current stream (a capture stream while the engine captures a
step program), raises on a launch error, and counts its launches in a
plain module-level integer ``launches``. A replayed CUDA graph launches
the kernels it recorded without calling the wrappers: the engine's
program cache (``engine/step_programs.py``) takes a capture's counts back
(a capture launches nothing) and adds what the graph recorded at every
replay. A wrapper accepts CUDA tensors only: the plain PyTorch versions
for the CPU live in ``ops/attention.py`` and ``ops/quant.py``, whose
dispatchers choose by device.
"""

from __future__ import annotations

import importlib

import torch


def _wrapper(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def launch_counts() -> dict[str, int]:
    """Every wrapper's ``launches``, by kernel."""
    # ``build`` is not imported with the package: ``python -m`` runs it.
    return {name: _wrapper(name).launches
            for name in _wrapper("build").KERNELS}


def set_launch_counts(counts: dict[str, int]) -> None:
    for name, n in counts.items():
        _wrapper(name).launches = n


def add_launches(counts: dict[str, int]) -> None:
    """A replay's launches, added to each kernel's count."""
    for name, n in counts.items():
        _wrapper(name).launches += n


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
