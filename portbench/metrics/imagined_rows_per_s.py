"""Imagined rows completed per second: start states x steps of every rollout
issued in the window (rows that terminated too: they were computed), over the
window's wall time, which ends when the card has finished them."""


def read(run):
    return run.rows / run.window_s
