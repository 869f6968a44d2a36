from repro_torch.data.pipeline import Cursor, SageTokenPipeline

__all__ = ["Cursor", "SageTokenPipeline"]
