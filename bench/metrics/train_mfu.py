"""The traced steps' model FLOPs (forward and backward, no recomputation,
``bench/roofline.py``) over the traced window, as a share of the card's
dense bf16 peak."""

from bench import roofline


def read(rec):
    if rec.window.busy_s <= 0:
        return None
    return 100 * rec.step_flops * rec.steps / rec.window.window_s / roofline.BF16_FLOPS
