"""Device milliseconds a rollout step spends in the TS1 shuffle around K3:
the rows gathered into each member's shard (GaussianMLP._permute_rows) and
put back in order (GaussianMLP._unpermute_rows): the time of the device
operations launched inside either span, over the calls of the first."""

PERMUTE, UNPERMUTE = "GaussianMLP._permute_rows", "GaussianMLP._unpermute_rows"


def read(run):
    trace = run.trace
    calls = trace.span_calls.get(PERMUTE, 0) if trace else 0
    if not calls or not (PERMUTE in trace.span_device_s or UNPERMUTE in trace.span_device_s):
        return None
    device_s = trace.span_device_s.get(PERMUTE, 0.0) + trace.span_device_s.get(UNPERMUTE, 0.0)
    return 1e3 * device_s / calls
