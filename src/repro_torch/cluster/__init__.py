from repro_torch.cluster.sim import (  # noqa: F401
    Condition,
    Link,
    Sim,
    TransferAborted,
)
from repro_torch.cluster.network import (  # noqa: F401
    LinkSpec,
    NetworkTopology,
    TOPOLOGY_PRESETS,
    available_topologies,
    edge_wan_topology,
    flat_topology,
    make_topology,
    topology_entries,
    two_zone_topology,
)
from repro_torch.cluster.cluster import (  # noqa: F401
    APIServer,
    Cluster,
    Node,
    Pod,
    TimingConstants,
)
from repro_torch.cluster.faults import (  # noqa: F401
    FAULT_KINDS,
    Fault,
    FaultInjector,
    FaultSchedule,
    make_schedule,
    parse_fault,
)


def __getattr__(name):
    # lazy: controller pulls in repro_torch.core (orchestrator, policy) — an
    # eager import here would cycle through core/__init__ back into this
    # package before it finishes initialising
    if name in ("RebalanceConfig", "RebalanceController",
                "run_rebalance_scenario"):
        from repro_torch.cluster import controller
        return getattr(controller, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
