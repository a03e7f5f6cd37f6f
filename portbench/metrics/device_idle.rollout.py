"""The share of the traced window in which no operation ran on the card (the
union of the device's intervals, as ``profile_busy`` merges them), in
percent."""


def read(run):
    trace = run.trace
    if not trace or not trace.device_ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
