"""Device milliseconds a rollout step spends making the model's input
(TransitionRewardModel._model_input: the concatenation, the float64
normaliser and the cast back): the time of the device operations launched
inside the span ``TransitionRewardModel._model_input``, over its calls."""

SPAN = "TransitionRewardModel._model_input"


def read(run):
    trace = run.trace
    calls = trace.span_calls.get(SPAN, 0) if trace else 0
    if not calls or SPAN not in trace.span_device_s:
        return None
    return 1e3 * trace.span_device_s[SPAN] / calls
