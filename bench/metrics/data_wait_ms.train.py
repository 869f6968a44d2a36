"""Mean host milliseconds a traced step waits for its batch: the harness's
``data_wait`` span around the pipeline's next batch and its copy to the card."""


def read(rec):
    return rec.spans.mean_ms("data_wait", rec.t_window)
