from .tokens import SyntheticLM

__all__ = ["SyntheticLM"]
