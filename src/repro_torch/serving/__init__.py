"""Serving: SAGe's k-mer prompts into the LM engine."""

from repro_torch.serving.engine import SageServer, ServeConfig, ServingEngine, prompts_from_store

__all__ = ["prompts_from_store", "ServeConfig", "ServingEngine", "SageServer"]
