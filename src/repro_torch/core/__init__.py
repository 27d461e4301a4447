"""TokenScale core: the paper's contribution.

  velocity     — Token Velocity metric + offline profiler (§III-B, §IV-B)
  autoscaler   — TokenScale policy (Eq.2-4) + AIBrix/BlitzScale/DistServe
                 + the string-keyed policy registry (@register_policy)
  convertible  — Convertible Decoder planning (Eq.5-6, pool sizing)
  router       — Alg.1 prefill routing, decode balancing, burst detector
  predictor    — simulated output-length predictor (§IV-B1)
  hardware     — chip profiles + analytic step-latency model
  fleet        — pool-centric control plane: PoolSpec/FleetSpec/
                 ExperimentSpec, FleetObservation/FleetPlan, FleetPolicy
  gateway      — KV-locality placement: prefix hashtrie, locality score,
                 hot-prefix replication planning
"""
from repro_torch.core.autoscaler import (  # noqa: F401
    POLICY_REGISTRY, AIBrixPolicy, BlitzScalePolicy, DistServePolicy,
    Observation, Policy, ScaleDecision, TokenScalePolicy, build_policy,
    register_policy,
)
from repro_torch.core.convertible import (  # noqa: F401
    ConvertibleConfig, burst_ratio_of_trace, default_convertible_plan,
    plan_convertible,
)
from repro_torch.core.fleet import (  # noqa: F401
    ExperimentSpec, FleetObservation, FleetPlan, FleetPolicy, FleetSpec,
    GatewayStats, PerModelFleetPolicy, PoolSnapshot, PoolSpec, TraceRoute,
    single_pool_fleet,
)
from repro_torch.core.gateway import (  # noqa: F401
    Gateway, GatewayConfig, PrefixHashTrie, ReplicationJob, RoutingStats,
    prefix_chain,
)
from repro_torch.core.hardware import CHIPS, ChipSpec, InstanceSpec  # noqa: F401
from repro_torch.core.predictor import OutputPredictor  # noqa: F401
from repro_torch.core.router import (  # noqa: F401
    PRIORITY_BATCH, PRIORITY_INTERACTIVE, PRIORITY_STANDARD, TPOT_SLO,
    BurstDetector, Router, tpot_slo, ttft_slo,
)
from repro_torch.core.velocity import (  # noqa: F401
    BUCKETS, VelocityProfile, bucket_lengths, bucket_of, profile,
    profile_for,
)
