"""Serving: the multi-tenant SageServer frontend (scheduler, continuous
batcher, session pool) and the LM engine fed by SAGe's k-mer prompts."""

from repro_torch.serving.engine import (
    SageServer,
    ServeConfig,
    ServingEngine,
    prompts_from_store,
)
from repro_torch.serving.scheduler import (
    DeadlineExceededError,
    QueueFullError,
    Request,
    RequestState,
    ResponseHandle,
    Scheduler,
)
from repro_torch.serving.batching import ContinuousBatcher
from repro_torch.serving.session_pool import SessionPool

__all__ = [
    "prompts_from_store", "ServeConfig", "ServingEngine", "SageServer",
    "Request", "RequestState", "ResponseHandle", "Scheduler", "QueueFullError",
    "DeadlineExceededError", "ContinuousBatcher", "SessionPool",
]
