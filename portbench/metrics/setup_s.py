"""Seconds from the start of the process to the first timed rollout: imports,
the card's start, the kernels' build where it is not cached, the weights, the
buffers and one warm rollout."""


def read(run):
    return run.setup_s
