"""B6's share of its roofline in a traced training step: the least time of
every forward and backward launch at the cell's shape (``bench/roofline.py``,
bf16 x) over their measured device time."""

from bench import roofline


def read(rec):
    fs, fn = rec.window.device_s("ssd_intra_prefill_kernel")
    bs, bn = rec.window.device_s("ssd_bwd_kernel")
    if not fn or not bn:
        return None
    least_ms = fn * roofline.ssd_bound(rec.ssd_shape, 2)[0] + bn * roofline.ssd_bwd_bound(rec.ssd_shape, 2)[0]
    return 100 * least_ms / (1e3 * (fs + bs))
