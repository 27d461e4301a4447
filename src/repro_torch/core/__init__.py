"""TokenScale control plane, copied from the reference package's ``core``
(the same code; only the import paths differ), so the port runs it
without JAX.

  velocity    — Token Velocity metric + offline profiler (§III-B, §IV-B)
  autoscaler  — TokenScale policy (Eq.2-4) and the baselines
  router      — Alg.1 prefill routing, decode balancing, burst detector
  predictor   — simulated output-length predictor (§IV-B1)
  hardware    — chip profiles + analytic step-latency model
"""
from repro_torch.core.autoscaler import (  # noqa: F401
    POLICY_REGISTRY, AIBrixPolicy, BlitzScalePolicy, DistServePolicy,
    Observation, Policy, ScaleDecision, TokenScalePolicy, build_policy,
    register_policy,
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
