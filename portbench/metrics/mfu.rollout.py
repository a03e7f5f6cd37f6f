"""The whole rollout's share of the card's peak: the operations of the
policy's and the ensemble's products that the window's rows need (2 per
multiply-add, from the configuration's widths), over the traced window's wall
time at 495 TFLOP/s, the dense TF32 tensor rate, which no float32 product on
this card exceeds; in percent."""
from portbench.yardstick import (PEAK_TF32, ensemble_dims, policy_dims,
                                 rollout_flops_per_row)


def read(run):
    if not run.trace or not run.trace.device_ops:
        return None
    sz = run.cell.sz
    per_row = rollout_flops_per_row(policy_dims(sz.obs, sz.policy_hidden, sz.act),
                                    ensemble_dims(sz.model_in, sz.hid, sz.layers,
                                                  2 * sz.model_out))
    return 100.0 * per_row * run.rows / (run.window_s * PEAK_TF32)
