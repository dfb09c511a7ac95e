"""The LM stack's dense-family decode path (torch twin of ``repro.models``)."""
from .model import Model, build_model

__all__ = ["Model", "build_model"]
