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
