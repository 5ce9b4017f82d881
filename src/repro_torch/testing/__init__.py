"""Deterministic failure tooling for tests, CI chaos legs, and benches."""
from repro_torch.testing.faults import (FaultInjector, FaultRule, active_injector,
                                  from_env, injected, install, maybe_fail,
                                  uninstall)

__all__ = ["FaultInjector", "FaultRule", "active_injector", "from_env",
           "injected", "install", "maybe_fail", "uninstall"]
