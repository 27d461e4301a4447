"""The decode attention kernels' share of their roofline: the bound of the
traced steps' calls (``flops.decode_attn`` over every slot's cached positions,
one call a layer a decode step) over the device seconds of
``decode_tc_kernel`` and ``decode_combine_kernel`` in the trace."""
from portbench import flops

KERNELS = ("decode_tc_kernel", "decode_combine_kernel")


def read(run):
    if run.trace is None or run.peak is None or "head_dim" not in run.dims:
        return None
    dev = sum(s for n, s in run.trace["kernel_s"].items()
              if any(k in n for k in KERNELS))
    if dev <= 0:
        return None
    L = run.dims["num_hidden_layers"]
    bound = sum(flops.bound_s(*flops.decode_attn(run.dims, c["keys"]),
                              run.peak)
                for c in run.traced_calls("decode")) * L
    return 100.0 * bound / dev
