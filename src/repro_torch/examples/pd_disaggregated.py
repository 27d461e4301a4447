"""PD-disaggregated serving on real PyTorch engines (paper Fig. 1 + 8).

Prefillers compute prompt KVC, the network stage ships it to decoders
(kvtransfer), the Router runs Alg. 1, bursts hit the Convertible Decoder,
and the Scaler reacts to live Observations — the whole TokenScale
architecture, executing actual models:

    PYTHONPATH=src python -m repro_torch.examples.pd_disaggregated
    PYTHONPATH=src python -m repro_torch.examples.pd_disaggregated \\
        --device cpu --engine=events

After the real-engine run, the same PD architecture is cross-checked at
cluster scale on the analytic simulator; ``--engine`` picks the fluid or
the discrete-event implementation (DESIGN.md).
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import CHIPS, InstanceSpec, TokenScalePolicy, profile
from repro_torch.models import init_params
from repro_torch.serving import PDCluster, Request


def sim_crosscheck(engine: str):
    """The same PD-disaggregated scenario shape at cluster scale, on the
    analytic simulator (which engine is selectable), plus the
    heterogeneous variant the pool-centric control plane enables:
    a100-TP2 prefillers feeding h100-TP1 decoders via one declarative
    ExperimentSpec (core.fleet)."""
    from repro_torch.sim.runner import hetero_demo_spec, run_policy, run_spec
    rep = run_policy("tokenscale", "azure_conv", duration=30.0, rps=6.0,
                     seed=0, engine=engine)
    print(f"\n[{engine} sim cross-check] {len(rep.requests)} requests, "
          f"SLO = {rep.slo_attainment() * 100:.1f}%, "
          f"p99 TTFT = {rep.percentile('ttft', 99) * 1e3:.0f} ms, "
          f"avg GPUs = {rep.avg_gpus():.2f}")
    het = run_spec(hetero_demo_spec(duration=30.0, rps=6.0, engine=engine))
    print(f"[{engine} hetero fleet: a100-TP2 prefill -> h100-TP1 decode] "
          f"SLO = {het.slo_attainment() * 100:.1f}%, "
          f"p99 TTFT = {het.percentile('ttft', 99) * 1e3:.0f} ms, "
          f"avg GPUs = {het.avg_gpus():.2f}")


def parse_args(argv):
    """Validate --engine up front: the real-engine demo takes a while, so
    a typo'd engine name must fail before it, not after."""
    from repro_torch.sim.runner import get_engine
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", default="fluid")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    get_engine(args.engine)
    return args


def serve(device: str):
    """The real-engine run on `device`: returns the cluster and its
    requests after the drain."""
    cfg = get_config("llama-3.1-8b", smoke=True)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    prof = profile(get_config("llama-3.1-8b"), InstanceSpec(CHIPS["h100"], 4))
    cl = PDCluster(cfg, params, TokenScalePolicy(prof, convertible=1),
                   n_prefillers=1, n_decoders=1, n_convertible=1,
                   max_len=96, chunk_size=16)

    rng = np.random.RandomState(0)
    # steady trickle ...
    reqs = [Request(rid=i,
                    prompt=rng.randint(0, cfg.vocab_size,
                                       size=(int(rng.randint(5, 15)),)
                                       ).astype(np.int32),
                    max_new_tokens=8) for i in range(4)]
    # ... then a token burst (few requests, long prompts — Fig.6's T2 case)
    reqs += [Request(rid=100 + i,
                     prompt=rng.randint(0, cfg.vocab_size,
                                        size=(48,)).astype(np.int32),
                     max_new_tokens=8) for i in range(2)]
    for r in reqs:
        cl.submit(r)
    cl.run_until_drained()
    return cl, reqs


def main(argv=None):
    args = parse_args(argv)
    cl, reqs = serve(args.device)

    done = sum(1 for r in reqs if len(r.output) == r.max_new_tokens)
    print(f"completed {done}/{len(reqs)} requests")
    print(f"prefillers={len(cl.prefillers)} decoders={len(cl.decoders)} "
          f"convertibles={len(cl.convertibles)}")
    t = cl.transfers
    print(f"KVC transfers: {t.n_transfers}  "
          f"{t.total_bytes / 1e6:.2f} MB total, "
          f"{t.bytes_per_token():.0f} B/token")
    print(f"measured network velocity @50 GB/s link: "
          f"{cl.measured_network_velocity():,.0f} tok/s")
    for r in reqs[:3] + reqs[-1:]:
        print(f"  req{r.rid}: {r.output}")

    sim_crosscheck(args.engine)


if __name__ == "__main__":
    main()
