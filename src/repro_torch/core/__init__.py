"""The paper's primary contribution: cost-model-driven control of intra- and
inter-query parallelism (estimators → cost model → bounds → packaging →
selective sequential execution → multi-query engine); see
``docs/ARCHITECTURE.md`` for the full pipeline and per-module map."""
from .estimators import (
    TraversalEstimator,
    estimate_found_closed_form,
    estimate_found_paper_form,
    estimate_found_sampled,
    estimate_touched_closed_form,
    estimate_touched_exact,
    estimate_touched_sampled,
)
from .descriptors import (
    REGISTRY as DESCRIPTORS,
    AlgorithmDescriptor,
    BFS_TOP_DOWN,
    DEGREE_COUNT,
    ItemCost,
    PR_PULL,
    PR_PUSH,
)
from .contention import (
    PRESET_VERSION,
    PRESETS,
    XEON_E5_2660V4,
    HardwareModel,
    MemoryLevel,
    calibrate_from_runs,
    counter_array_bytes,
    cross_domain_cost_ns,
    recalibrate_preset,
)
from .calibration import CalibrationStore, host_fingerprint
from .cost_model import (
    IterationWork,
    c_sub,
    c_vertex_sequential,
    c_vertex_total,
    iteration_cost_ns,
    touched_memory_bytes,
)
from .bounds import ThreadBounds, parallel_beats_sequential, thread_bounds, v_min_for_parallel
from .packaging import WorkPackages, make_packages, packages_to_table
from .autotuner import PreparedIteration, prepare_iteration
from .scheduler import (
    STALL_STEP,
    PackageRun,
    PackageScheduler,
    ScheduleRun,
    ScheduleStep,
    ScheduleTrace,
    WorkerPool,
    largest_pow2_leq,
)
from .stealing import StealEntry, StealRegistry, graph_identity
from .backends import (
    DevicePlan,
    ExecutionBackend,
    InlineBackend,
    ModeledBackend,
    CudaBackend,
    resolve_backend,
)
from .config import EngineConfig
from .fusion import (
    FusionConfig,
    FusionGroup,
    FusionMember,
    aggregate_work,
    apply_scan_sharing,
    member_scan_ns,
    plan_gang_width,
    plan_hetero_gang_width,
)
from .governor import CapacityGovernor, GovernorConfig
from .session import (
    AdmissionController,
    EngineReport,
    IngestStream,
    MultiQueryEngine,
    PoissonArrivals,
    QueryExecutor,
    QueryRecord,
)
from .feedback import CostFeedback

__all__ = [
    "TraversalEstimator", "estimate_found_closed_form", "estimate_found_paper_form",
    "estimate_found_sampled", "estimate_touched_closed_form", "estimate_touched_exact",
    "estimate_touched_sampled",
    "DESCRIPTORS", "AlgorithmDescriptor", "BFS_TOP_DOWN", "DEGREE_COUNT", "ItemCost",
    "PR_PULL", "PR_PUSH",
    "PRESET_VERSION", "PRESETS", "XEON_E5_2660V4",
    "HardwareModel", "MemoryLevel",
    "calibrate_from_runs", "counter_array_bytes", "cross_domain_cost_ns",
    "recalibrate_preset",
    "CalibrationStore", "host_fingerprint",
    "IterationWork", "c_sub", "c_vertex_sequential", "c_vertex_total",
    "iteration_cost_ns", "touched_memory_bytes",
    "ThreadBounds", "parallel_beats_sequential", "thread_bounds", "v_min_for_parallel",
    "WorkPackages", "make_packages", "packages_to_table",
    "PreparedIteration", "prepare_iteration",
    "PackageRun", "PackageScheduler", "ScheduleRun", "ScheduleStep",
    "ScheduleTrace", "STALL_STEP", "WorkerPool", "largest_pow2_leq",
    "StealEntry", "StealRegistry", "graph_identity",
    "CudaBackend", "DevicePlan", "ExecutionBackend", "InlineBackend",
    "ModeledBackend", "resolve_backend", "EngineConfig",
    "FusionConfig", "FusionGroup", "FusionMember", "aggregate_work",
    "apply_scan_sharing", "member_scan_ns", "plan_gang_width",
    "plan_hetero_gang_width",
    "CapacityGovernor", "GovernorConfig",
    "AdmissionController", "EngineReport", "IngestStream", "MultiQueryEngine",
    "PoissonArrivals", "QueryExecutor", "QueryRecord",
    "CostFeedback",
]
