from repro_torch.sim.cluster import Cluster, SimReport, SimRequest  # noqa: F401
from repro_torch.sim.events import EventCluster  # noqa: F401
from repro_torch.sim.instances import (  # noqa: F401
    ClusterBase, Decoder, Fleet, ModelCost, ModelGroup, Pool, Prefiller,
    PreemptionPolicy,
)
from repro_torch.sim.kvcache import (  # noqa: F401
    KVAllocator, KVError, KVStats, KVTierConfig,
)
from repro_torch.sim.traces import (  # noqa: F401
    DEFAULT_PRIORITY_MIX, PRIORITY_CLASSES, TRACES, TraceRequest, TraceSpec,
    TraceStats, assign_priorities, assign_sessions, assign_shared_prefixes,
    generate, generate_mixed, get_trace, step_trace, stream_trace,
    trace_stats,
)
from repro_torch.sim.runner import (  # noqa: F401
    ENGINES, build_fleet, build_traces, compare_engines, compare_policies,
    get_engine, make_policy, run_policy, run_spec,
)
