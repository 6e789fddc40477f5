# The paper's primary contribution: MS2M live stateful migration integrated
# with the cluster control plane, the Threshold-Based Cutoff Mechanism
# (queuing-theory bound, Eq. 5), and FCC-style registry checkpoint images —
# adapted from Kubernetes/CRIU to a multi-pod fleet.
from repro_torch.core.consumer import StatefulConsumer, measure_replay_speedup  # noqa: F401
from repro_torch.core.cutoff import (  # noqa: F401
    CutoffController,
    batched_cutoff_threshold,
    choose_adaptive_strategy,
    cutoff_threshold,
    expected_catchup_time,
    replay_time_bound,
)
from repro_torch.core.migration import MigrationManager, MigrationReport  # noqa: F401
from repro_torch.core.policy import MigrationEvent, MigrationPolicy  # noqa: F401
from repro_torch.core.strategy import (  # noqa: F401
    MigrationContext,
    MigrationError,
    MigrationStrategy,
    TargetNodeLost,
    available_strategies,
    get_strategy,
    register_strategy,
    registry_entries,
)
from repro_torch.core.orchestrator import (  # noqa: F401
    ClusterMigrationOrchestrator,
    FleetReport,
    PLACEMENT_POLICIES,
    PodMigrationSpec,
    available_placements,
    run_fleet_experiment,
)
from repro_torch.core.workload import (  # noqa: F401
    ExperimentResult,
    HashConsumer,
    make_torch_worker_factory,
    open_loop_gaps,
    request_stream,
    run_migration_experiment,
)
