from .pipeline import PrefetchingLoader, SyntheticLM

__all__ = ["PrefetchingLoader", "SyntheticLM"]
