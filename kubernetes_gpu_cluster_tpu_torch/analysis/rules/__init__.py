"""kgct-torch-lint rule registry.

Each module owns one invariant class; every rule here runs in the tier-1
empty-baseline test (tests/test_torch_lint.py): adding a rule means the
whole package must already satisfy it. The codes are the JAX package's.
KGCT001 (capture-safety), KGCT003 (recompile-risk) and KGCT004
(donation-safety) police the engine's captured decode programs
(``engine/step_programs.py``), the counterparts of the JAX package's
traced functions, jit cache and donated buffers.
"""

from .trace_safety import TraceSafetyRule
from .host_sync import HostSyncRule
from .recompile import RecompileRiskRule
from .donation import DonationSafetyRule
from .kv_commit import KVCommitSafetyRule
from .asyncio_hygiene import AsyncioHygieneRule
from .metric_hygiene import MetricHygieneRule
from .logging_hygiene import LoggingHygieneRule
from .quant_surface import QuantSurfaceRule
from .router_pick import RouterPickPathRule
from .swap_order import SwapOrderRule
from .trace_emit import TraceEmitHygieneRule
from .kv_boundary import KVBoundaryRule
from .migration_state import MigrationStateSafetyRule
from .tenant_accounting import TenantAccountingSafetyRule
from .fleet_fetch import FleetFetchBoundaryRule
from .draft_state import DraftStateBoundaryRule
from .wire_integrity import WireIntegrityRule
from .await_atomicity import AwaitAtomicityRule
from .thread_ownership import ThreadOwnershipRule
from .lock_discipline import LockDisciplineRule

ALL_RULES = [
    TraceSafetyRule(),
    HostSyncRule(),
    RecompileRiskRule(),
    DonationSafetyRule(),
    KVCommitSafetyRule(),
    AsyncioHygieneRule(),
    MetricHygieneRule(),
    LoggingHygieneRule(),
    QuantSurfaceRule(),
    SwapOrderRule(),
    RouterPickPathRule(),
    TraceEmitHygieneRule(),
    KVBoundaryRule(),
    MigrationStateSafetyRule(),
    TenantAccountingSafetyRule(),
    FleetFetchBoundaryRule(),
    DraftStateBoundaryRule(),
    WireIntegrityRule(),
    AwaitAtomicityRule(),
    ThreadOwnershipRule(),
    LockDisciplineRule(),
]


def rules_by_code(codes) -> list:
    """Resolve a --select list (codes or names, case-insensitive)."""
    wanted = {c.strip().upper() for c in codes if c.strip()}
    out = [r for r in ALL_RULES
           if r.code.upper() in wanted or r.name.upper() in wanted]
    known = {r.code.upper() for r in ALL_RULES} | {r.name.upper()
                                                  for r in ALL_RULES}
    unknown = wanted - known
    if unknown:
        raise ValueError(f"unknown rule(s): {', '.join(sorted(unknown))}")
    return out


__all__ = ["ALL_RULES", "rules_by_code"]
