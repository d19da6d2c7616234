"""Fault tolerance: the deterministic ``KGCT_FAULT`` injection harness
(``faults``). The admission, watchdog and drain pieces of the JAX package
come with the HTTP server (ROADMAP R1)."""

from .faults import FaultInjector, configure_faults, get_injector, inject  # noqa: F401
