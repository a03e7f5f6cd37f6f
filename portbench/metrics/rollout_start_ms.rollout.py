"""Device milliseconds a rollout spends in its start (start_rollout:
``reset``, every step's TS1 permutation and its inverse, ``shard``): the time
of the device operations launched inside the span ``start_rollout``, over its
calls."""

SPAN = "start_rollout"


def read(run):
    trace = run.trace
    calls = trace.span_calls.get(SPAN, 0) if trace else 0
    if not calls or SPAN not in trace.span_device_s:
        return None
    return 1e3 * trace.span_device_s[SPAN] / calls
