from .pipeline import StreamingInferencePipeline

__all__ = ["StreamingInferencePipeline"]
