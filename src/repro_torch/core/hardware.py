"""Hardware profiles + analytic step-latency model.

The paper profiles Token Velocity per (model, GPU) pair on real clusters
(A100/H100).  We reproduce the same *methodology* with an analytic roofline
cost model over published chip constants — the offline profiler sweeps
request rates against this model exactly as §IV-B sweeps them against real
engines — and add the TPU v5e profile that the JAX/Pallas substrate targets.

Efficiency factors are calibrated so Llama-3.1-8B/A100 decode velocities
land inside the paper's Table II band (see tests/test_velocity.py).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class ChipSpec:
    name: str
    flops_bf16: float          # FLOP/s per chip
    hbm_bw: float              # bytes/s
    hbm_cap: float             # bytes
    net_bw: float              # bytes/s inter-instance (KVC transfer)
    mfu: float = 0.55          # achievable fraction of peak compute
    mbu: float = 0.70          # achievable fraction of peak HBM bandwidth
    startup_s: float = 5.0     # instance boot (weights load + runtime init)
    cost_per_hour: float = 1.0
    # host-DRAM KV offload tier (sim.kvcache): bytes of pinned host memory
    # available per chip, and the effective HBM<->host swap bandwidth
    # (PCIe/DMA sustained, not the link peak)
    host_dram_cap: float = 0.0
    swap_bw: float = 0.0


CHIPS: dict[str, ChipSpec] = {
    # 4xA100-40G nodes, NVLink3 600GB/s agg, 2x200Gb IB (paper §V).
    # mfu calibrated so V_P(llama-3.1-8b) ~ Table I's 14K tok/s threshold.
    # Host tier: PCIe4 x16 (~20 GB/s sustained DMA), 64 GB pinned per chip.
    "a100": ChipSpec("a100", 312e12, 1.555e12, 40e9, 25e9,
                     mfu=0.72, mbu=0.60, startup_s=5.0, cost_per_hour=4.0,
                     host_dram_cap=64e9, swap_bw=20e9),
    # 8xH100-80G nodes, NVLink 1200GB/s (paper uses "3.0" loosely), 2880Gb
    # Host tier: PCIe5 x16 (~45 GB/s sustained), 128 GB pinned per chip.
    "h100": ChipSpec("h100", 989e12, 3.35e12, 80e9, 360e9,
                     mfu=0.50, mbu=0.65, startup_s=5.0, cost_per_hour=8.0,
                     host_dram_cap=128e9, swap_bw=45e9),
    # TPU v5e — the JAX substrate's target (roofline constants used by
    # launch/roofline.py as well); host tier over PCIe3-class DMA.
    "v5e": ChipSpec("v5e", 197e12, 8.19e11, 16e9, 50e9,
                    mfu=0.55, mbu=0.70, startup_s=4.0, cost_per_hour=1.2,
                    host_dram_cap=48e9, swap_bw=12e9),
    # L40S-48G (Ada): dense-BF16 compute near A100 but GDDR6 bandwidth
    # (864 GB/s) and PCIe-only interconnect — low absolute decode velocity,
    # yet the best decode tokens/s/$ of the menu at ~1.8 $/hr.  The chip
    # the cost-aware planner should prefer for decode when SLOs allow.
    "l40s": ChipSpec("l40s", 181e12, 8.64e11, 48e9, 25e9,
                     mfu=0.60, mbu=0.70, startup_s=5.0, cost_per_hour=1.8,
                     host_dram_cap=64e9, swap_bw=20e9),
}

V5E = CHIPS["v5e"]


@dataclass(frozen=True)
class InstanceSpec:
    """One inference instance = `tp` chips running `model`."""
    chip: ChipSpec
    tp: int = 1

    @property
    def flops(self) -> float:
        return self.chip.flops_bf16 * self.tp * self.chip.mfu

    @property
    def hbm_bw(self) -> float:
        return self.chip.hbm_bw * self.tp * self.chip.mbu

    @property
    def hbm_cap(self) -> float:
        return self.chip.hbm_cap * self.tp

    @property
    def gpus(self) -> int:
        return self.tp

    @property
    def host_dram_cap(self) -> float:
        """Host-DRAM offload bytes: each chip brings its own pinned pool."""
        return self.chip.host_dram_cap * self.tp

    @property
    def swap_bw(self) -> float:
        """HBM<->host swap bandwidth: each chip swaps over its own lanes."""
        return self.chip.swap_bw * self.tp

    @property
    def cost_rate(self) -> float:
        return self.chip.cost_per_hour * self.tp / 3600.0


# ---------------------------------------------------------------------------
# Model byte/flop accounting
# ---------------------------------------------------------------------------

def weight_bytes(cfg: ModelConfig, bytes_per_param: int = 2) -> float:
    return cfg.param_counts()["total"] * bytes_per_param


def active_weight_bytes(cfg: ModelConfig, bytes_per_param: int = 2) -> float:
    return cfg.param_counts()["active"] * bytes_per_param


def kv_bytes_per_token(cfg: ModelConfig, bytes_per_el: int = 2) -> float:
    """Per-token recurrent/cache footprint across all layers.

    Respects ``kv_cache_dtype="int8"`` (1 byte/element + one f32 scale per
    (token, head)): the quantized cache roughly halves the footprint —
    and therefore roughly DOUBLES the memory-capacity-bound decode batch
    and the decode Token Velocity (Eq. 1) the profiler reports."""
    if cfg.kv_cache_dtype == "int8":
        per_el: float = 1.0
        scale_overhead = 4.0  # f32 scale per (token, head)
    else:
        per_el = float(bytes_per_el)
        scale_overhead = 0.0
    total = 0.0
    for spec in cfg.layer_specs:
        if spec.mixer in ("attn", "local_attn"):
            if cfg.kv_lora_rank:
                # MLA latent cache is kept at full precision
                total += (cfg.kv_lora_rank + cfg.qk_rope_dim) * bytes_per_el
            else:
                total += 2 * cfg.num_kv_heads * (cfg.head_dim_ * per_el
                                                 + scale_overhead)
        # mamba/rwkv state is O(1) in sequence — amortized to ~0 per token
    return total


def state_bytes_fixed(cfg: ModelConfig, bytes_per_el: int = 2) -> float:
    """Sequence-independent recurrent state (SSM/RWKV) per request."""
    total = 0.0
    for spec in cfg.layer_specs:
        if spec.mixer == "mamba":
            mc = cfg.mamba
            di = mc.expand * cfg.d_model
            total += di * mc.d_state * 4 + (mc.d_conv - 1) * di * bytes_per_el
        elif spec.mixer == "rwkv":
            h = cfg.d_model // cfg.rwkv_head_dim
            total += h * cfg.rwkv_head_dim ** 2 * 4 + 2 * cfg.d_model * 2
    return total


def flops_per_token(cfg: ModelConfig) -> float:
    """Dense-equivalent forward FLOPs per token: 2 * N_active."""
    return 2.0 * cfg.param_counts()["active"]


def attn_flops_per_token(cfg: ModelConfig, context: float) -> float:
    """Attention score/value FLOPs per token at a given context length."""
    total = 0.0
    for spec in cfg.layer_specs:
        if spec.mixer in ("attn", "cross_attn"):
            eff = cfg.num_vision_tokens if spec.mixer == "cross_attn" else context
            total += 4.0 * cfg.num_heads * cfg.head_dim_ * eff
        elif spec.mixer == "local_attn":
            total += 4.0 * cfg.num_heads * cfg.head_dim_ * min(
                context, cfg.sliding_window or context)
    return total


# ---------------------------------------------------------------------------
# Step-latency model (drives both the profiler and the cluster simulator)
# ---------------------------------------------------------------------------

def prefill_time(cfg: ModelConfig, inst: InstanceSpec, n_tokens: int,
                 context: float = 0.0) -> float:
    """Seconds to prefill `n_tokens` (compute-bound stage)."""
    f = n_tokens * (flops_per_token(cfg)
                    + attn_flops_per_token(cfg, context + n_tokens / 2))
    t_compute = f / inst.flops
    t_memory = active_weight_bytes(cfg) / inst.hbm_bw
    return max(t_compute, t_memory)


def decode_iter_time(cfg: ModelConfig, inst: InstanceSpec, batch: int,
                     avg_context: float) -> float:
    """Seconds per decode iteration for `batch` concurrent requests."""
    if batch <= 0:
        return 0.0
    mem = (active_weight_bytes(cfg)
           + batch * (kv_bytes_per_token(cfg) * avg_context
                      + state_bytes_fixed(cfg)))
    t_mem = mem / inst.hbm_bw
    f = batch * (flops_per_token(cfg)
                 + attn_flops_per_token(cfg, avg_context))
    t_compute = f / inst.flops
    return max(t_mem, t_compute)


def max_batch(cfg: ModelConfig, inst: InstanceSpec, avg_tokens: float,
              reserve_bytes: float = 0.0, hbm_frac: float = 0.9) -> int:
    """Max concurrent decode requests that fit in HBM.  ``hbm_frac`` is the
    usable fraction of HBM after allocator/runtime overheads (the same knob
    ``PoolSpec.hbm_frac`` threads into the simulated decoders)."""
    per_req = kv_bytes_per_token(cfg) * avg_tokens + state_bytes_fixed(cfg)
    free = inst.hbm_cap * hbm_frac - weight_bytes(cfg) - reserve_bytes
    return max(int(free / max(per_req, 1.0)), 0)


#: id(cfg) -> (cfg, kv_bytes_per_token, state_bytes_fixed); the strong cfg
#: reference both guards against id reuse and keeps the entry valid.  The
#: constants are pure functions of the config, but the layer-spec walk
#: behind them is ~30 us — too hot for the simulators' per-transfer path.
_KVC_CONSTS: dict[int, tuple] = {}


def kvc_transfer_time(cfg: ModelConfig, inst: InstanceSpec,
                      n_tokens: int) -> float:
    """Prefiller -> decoder KVC (or SSM state) transfer seconds."""
    ent = _KVC_CONSTS.get(id(cfg))
    if ent is None or ent[0] is not cfg:
        ent = _KVC_CONSTS[id(cfg)] = (
            cfg, kv_bytes_per_token(cfg), state_bytes_fixed(cfg))
    payload = ent[1] * n_tokens + ent[2]
    return payload / inst.chip.net_bw
