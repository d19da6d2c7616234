"""CUDA-graph conditional nodes: the wrapper of ``csrc/graph_gate.cu``.

No TPU kernel stands behind it: it is how a captured step program skips a
stage, as the JAX programs do with ``lax.cond`` (``ops/gates.py`` decides
when a stage becomes a conditional node). ``open_gate`` appends a one-thread
kernel that reads a device flag at every replay and an IF node after it to
the graph under capture on ``stream``, then starts ``child`` capturing into
the node's body; ``close_gate`` ends that. The flag lives on the device
(int32 or bool, one element) and must outlive the graph.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.library("graph_gate")
    if lib.kgct_gate_open.argtypes is None:
        lib.kgct_gate_open.argtypes = [_P, _P, _I, _I, _P]
        lib.kgct_gate_open.restype = _I
        lib.kgct_gate_close.argtypes = [_P]
        lib.kgct_gate_close.restype = _I
    return lib


def open_gate(stream: int, flag: torch.Tensor, negate: bool,
              child: int) -> None:
    """While ``stream`` captures: a conditional node on ``flag`` (its body
    runs when the flag is non-zero, or zero with ``negate``), its body
    captured from ``child`` until ``close_gate``. Raises on a CUDA error."""
    if (flag.device.type != "cuda" or flag.numel() != 1
            or flag.dtype not in (torch.int32, torch.bool)):
        raise ValueError(f"graph_gate: the flag must be one int32 or bool "
                         f"on the card, got {flag.dtype} {tuple(flag.shape)}"
                         f" on {flag.device}")
    lib = _lib()
    code = lib.kgct_gate_open(stream, flag.data_ptr(), flag.element_size(),
                              int(negate), child)
    if code:
        build.check_status(lib, "graph_gate", code)


def close_gate(child: int) -> None:
    """End ``child``'s capture into the body ``open_gate`` started."""
    lib = _lib()
    code = lib.kgct_gate_close(child)
    if code:
        build.check_status(lib, "graph_gate", code)
