"""kgct static analysis + runtime sanitizers, for the PyTorch port.

Two complementary halves guard the serving engine's hot-path invariants,
the properties no functional test can see until they break in production
(a hidden host sync, KV pages leaving through a second path, a stale KV
slot surviving a speculative rollback):

- ``kgct-torch-lint`` (:mod:`.core`, :mod:`.rules`, :mod:`.cli`): an
  AST-based lint framework whose rules speak torch's spelling
  (``.cpu()``, ``torch.cuda.synchronize``, ``F.linear``, ...) beside the
  JAX package's, run over the port by a tier-1 test with an EMPTY findings
  baseline. No torch import, no allowlist: every rule holds everywhere.
- runtime sanitizers (:mod:`.sanitize`, ``KGCT_SANITIZE=1``): NaN/inf and
  vocab guards on step outputs plus a KV-slot shadow asserting the
  spec-decode rollback contract dynamically; ``KGCT_SANITIZE_INTERLEAVE=1``
  injects seeded yields at the async engine's loop/worker seam. Wired into
  the ``KGCT_FAULT`` chaos harness so the detectors themselves are tested.
  Every hook is handed host (numpy) arrays the engine already holds, so
  the sanitizers add no device->host synchronization on the card.

Pure ``ast`` + numpy: nothing here imports torch or the JAX package.
"""

from .core import Finding, LintModule, Rule, iter_py_files, run_lint
from .rules import ALL_RULES, rules_by_code
from .sanitize import SanitizerError, StepSanitizer, build_step_sanitizer

__all__ = [
    "ALL_RULES", "Finding", "LintModule", "Rule", "SanitizerError",
    "StepSanitizer", "build_step_sanitizer", "iter_py_files", "run_lint",
    "rules_by_code",
]
