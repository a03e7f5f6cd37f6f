"""Device milliseconds a rollout step spends in the model's step (ModelEnv.step: normaliser, ensemble, draws, termination): the time of the
device operations launched inside the span ``ModelEnv.step``, over its calls."""

SPAN = "ModelEnv.step"


def read(run):
    trace = run.trace
    calls = trace.span_calls.get(SPAN, 0) if trace else 0
    if not calls or SPAN not in trace.span_device_s:
        return None
    return 1e3 * trace.span_device_s[SPAN] / calls
