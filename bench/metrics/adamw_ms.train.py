"""Device milliseconds a traced step in AdamW's multi-tensor kernels
(``_foreach`` ops: ``multi_tensor_apply_kernel``, and ``lpnorm_cleanup`` of
the global norm), by the profiler."""


def read(rec):
    s, n = rec.window.device_s("multi_tensor_apply_kernel", "lpnorm_cleanup")
    return 1e3 * s / rec.steps if n else None
