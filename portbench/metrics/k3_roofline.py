"""K3's share of its roofline: the least time of its calls on this card (the
larger of their operations at the TF32 peak, three TF32 products for each f32
one, or at the bf16 peak, and their bytes at the HBM peak; from each call's
shapes) over the device time of the operations launched inside the span
``fused_ensemble_mlp``, in percent."""
from portbench.yardstick import bound, k3_flops_bytes

SPAN = "fused_ensemble_mlp"


def read(run):
    trace = run.trace
    if not trace or not trace.span_device_s.get(SPAN) or not trace.span_args.get(SPAN):
        return None
    least_ms = 0.0
    for args, _ in trace.span_args[SPAN]:
        x, stack = args[0], args[1]
        flops, nbytes = k3_flops_bytes(x[1], stack)
        least_ms += bound(flops, nbytes, stack.low_precision)[0]
    return 100.0 * least_ms / (1e3 * trace.span_device_s[SPAN])
