"""Device milliseconds a traced step in B6: ``ssd_intra_prefill_kernel``
(forward, twice a layer under remat) and ``ssd_bwd_kernel``, by the profiler."""


def read(rec):
    s, n = rec.window.device_s("ssd_intra_prefill_kernel", "ssd_bwd_kernel")
    return 1e3 * s / rec.steps if n else None
