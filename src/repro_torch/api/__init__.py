"""MLego public API on PyTorch — typed queries against a session.

    from repro_torch.api import MLegoSession, QuerySpec, Interval

    session = MLegoSession(corpus, cfg)                 # runs on CUDA
    report  = session.submit(QuerySpec(sigma=Interval(0.0, 500.0),
                                       alpha=0.5))

The same public names as ``repro.api``; everything else in
``repro_torch.core`` is machinery behind this surface.
"""
from repro_torch.api.backend import (
    BACKEND_NAMES,
    BackendStats,
    DeviceBackend,
    ExecutionBackend,
    HostBackend,
    make_backend,
)
from repro_torch.api.executor import StalePlanError
from repro_torch.api.planner import PlanCache, Planner
from repro_torch.api.reports import BatchReport, QueryReport
from repro_torch.api.session import (
    CALIBRATION_SIDECAR,
    MLegoSession,
    calibration_sidecar,
)
from repro_torch.api.spec import (
    MATERIALIZE_POLICIES,
    PERSIST,
    VOLATILE,
    QuerySpec,
    normalize_sigma,
)
from repro_torch.api.trainers import (
    available_trainers,
    get_trainer,
    register_trainer,
    resolve_kind,
)
from repro_torch.core.cost import (
    CalibratedCostModel,
    Calibration,
    CostModel,
    CostProvider,
)
from repro_torch.core.errors import (
    CorruptModelError,
    DeviceLostError,
    ExecutionError,
    PermanentExecutionError,
    RetryPolicy,
    TransientExecutionError,
)
from repro_torch.core.plan_ir import FetchStep, MergeStep, Plan, TrainGapStep
from repro_torch.core.plans import Interval
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer

__all__ = [
    "BACKEND_NAMES",
    "BackendStats",
    "BatchReport",
    "CALIBRATION_SIDECAR",
    "CalibratedCostModel",
    "Calibration",
    "calibration_sidecar",
    "CorruptModelError",
    "CostModel",
    "CostProvider",
    "DeviceBackend",
    "DeviceLostError",
    "ExecutionError",
    "FetchStep",
    "HostBackend",
    "Interval",
    "MergeStep",
    "Plan",
    "PlanCache",
    "Planner",
    "TrainGapStep",
    "make_backend",
    "MATERIALIZE_POLICIES",
    "MetricsRegistry",
    "MLegoSession",
    "PERSIST",
    "PermanentExecutionError",
    "QueryReport",
    "QuerySpec",
    "RetryPolicy",
    "StalePlanError",
    "Tracer",
    "TransientExecutionError",
    "VOLATILE",
    "available_trainers",
    "get_trainer",
    "normalize_sigma",
    "register_trainer",
    "resolve_kind",
]
