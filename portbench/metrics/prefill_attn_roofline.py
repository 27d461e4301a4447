"""The prefill attention kernel's share of its roofline: the bound of the
traced steps' calls (``flops.prefill_attn``, one a layer a prefill or chunk)
over the device seconds of ``prefill_wg_kernel`` in the trace."""
from portbench import flops

KERNEL = "prefill_wg_kernel"


def read(run):
    if run.trace is None or run.peak is None or "head_dim" not in run.dims:
        return None
    dev = sum(s for n, s in run.trace["kernel_s"].items() if KERNEL in n)
    if dev <= 0:
        return None
    L = run.dims["num_hidden_layers"]
    bound = sum(flops.bound_s(*flops.prefill_attn(run.dims, c["start"],
                                                  c["n"]), run.peak)
                for c in run.traced_calls("prefill")) * L
    return 100.0 * bound / dev
