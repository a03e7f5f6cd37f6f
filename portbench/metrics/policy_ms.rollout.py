"""Device milliseconds a rollout step spends in the policy's action (SAC.act_tensor): the time of the
device operations launched inside the span ``SAC.act_tensor``, over its calls."""

SPAN = "SAC.act_tensor"


def read(run):
    trace = run.trace
    calls = trace.span_calls.get(SPAN, 0) if trace else 0
    if not calls or SPAN not in trace.span_device_s:
        return None
    return 1e3 * trace.span_device_s[SPAN] / calls
