"""Device milliseconds a rollout step spends in the masked write into the SAC buffer (DeviceReplayBuffer.add_batch_masked): the time of the
device operations launched inside the span ``DeviceReplayBuffer.add_batch_masked``, over its calls."""

SPAN = "DeviceReplayBuffer.add_batch_masked"


def read(run):
    trace = run.trace
    calls = trace.span_calls.get(SPAN, 0) if trace else 0
    if not calls or SPAN not in trace.span_device_s:
        return None
    return 1e3 * trace.span_device_s[SPAN] / calls
