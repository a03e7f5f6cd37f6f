"""The SAC policy's share of its roofline: the least time of its calls on
this card (``yardstick.bound`` of f32 products: three TF32 products each at
the TF32 peak, or the bytes at the HBM peak, whichever is larger) over the
device time of the operations launched inside the span
``GaussianPolicy.forward``, in percent. A call's operations are 2 per
multiply-add of its rows through the policy's products (``policy_dims`` of
the cell's widths: two hidden layers, the mean and log-std heads); its bytes
are the input rows, the weights and biases and the heads' outputs, each once
in f32, as ``k3_roofline`` counts K3's."""
from __future__ import annotations

import math

from portbench.yardstick import bound, macs_per_row, policy_dims

SPAN = "GaussianPolicy.forward"


def flops_bytes(rows: int, obs: int, hidden: int, act: int):
    """Operations and bytes of one call of the policy on ``rows`` rows."""
    dims = policy_dims(obs, hidden, act)
    macs = macs_per_row(dims)
    flops = 2.0 * rows * macs
    nbytes = 4.0 * (rows * (dims[0] + dims[-1]) + macs + sum(dims[1:]))
    return flops, nbytes


def _rows(args, kwargs) -> int:
    """The rows of a call's input: the first tensor argument's (described as
    ``("tensor", shape, element size)``) leading dimensions."""
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, tuple) and a and a[0] == "tensor":
            return math.prod(a[1][:-1])
    raise ValueError("a call of the policy without a tensor argument")


def read(run):
    trace = run.trace
    if not trace or not trace.span_device_s.get(SPAN) or not trace.span_args.get(SPAN):
        return None
    sz = run.cell.sz
    least_ms = 0.0
    for args, kwargs in trace.span_args[SPAN]:
        flops, nbytes = flops_bytes(_rows(args, kwargs), sz.obs, sz.policy_hidden, sz.act)
        least_ms += bound(flops, nbytes, False)[0]
    return 100.0 * least_ms / (1e3 * trace.span_device_s[SPAN])
