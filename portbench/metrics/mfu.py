"""The whole step's share of the card's bf16 peak: the model FLOPs of the
window's useful tokens (``flops.prefill_model_flops`` of each prefill or
chunk's valid tokens, ``flops.decode_model_flops`` of each decoding slot)
over the window's seconds times the peak."""
from portbench import flops


def read(run):
    if run.peak is None or run.window_s <= 0:
        return None
    d = run.dims
    total = sum(flops.prefill_model_flops(d, c["start"], c["n"])
                for c in run.window_calls("prefill"))
    total += sum(flops.decode_model_flops(d, c["decoding"])
                 for c in run.window_calls("decode"))
    return 100.0 * total / (run.window_s * run.peak["bf16_flops"])
