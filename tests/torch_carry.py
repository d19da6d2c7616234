"""Carry a JAX-package test file onto the port.

``carry`` loads ``tests/<name>.py`` with its imports re-pointed from
``kubernetes_gpu_cluster_tpu`` to ``kubernetes_gpu_cluster_tpu_torch`` and
exact substitutions applied (each must still match, or the load fails);
``expose`` publishes the carried cases in a test module's namespace under
names prefixed by their file: ``TestScheduler_Admission``,
``test_kv_cache__allocator_basic``.
"""

from __future__ import annotations

import inspect
import sys
import types
from pathlib import Path

TESTS = Path(__file__).resolve().parent
PORT = "kubernetes_gpu_cluster_tpu_torch"


def carry(name: str, fixes: list, **env) -> types.ModuleType:
    """``tests/<name>.py`` re-pointed at the port, ``env`` in its
    globals."""
    path = TESTS / f"{name}.py"
    src = path.read_text().replace("kubernetes_gpu_cluster_tpu.", PORT + ".")
    for old, new in fixes:
        if old not in src:
            raise AssertionError(f"{name}: seam {old!r} no longer matches")
        src = src.replace(old, new)
    mod = types.ModuleType(f"carried_{name}")
    mod.__file__ = str(path)
    mod.__dict__.update(env)
    sys.modules[mod.__name__] = mod
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def expose(name: str, mod: types.ModuleType, keep, namespace: dict,
           leave_out=()) -> None:
    """Every ``Test*`` class and ``test_*`` function of ``mod`` (only those
    in ``keep`` unless it is None, none in ``leave_out``) into
    ``namespace``; with ``keep``, also the fixtures it names."""
    stem = "".join(p.capitalize() for p in name[len("test_"):].split("_"))
    for attr, obj in list(vars(mod).items()):
        if (keep is not None and attr not in keep) or attr in leave_out:
            continue
        if attr.startswith("Test") and inspect.isclass(obj):
            namespace[f"Test{stem}_{attr[len('Test'):]}"] = obj
        elif attr.startswith("test_") and callable(obj):
            namespace[f"{name}__{attr[len('test_'):]}"] = obj
        elif keep is not None:                     # a named fixture
            namespace[attr] = obj
