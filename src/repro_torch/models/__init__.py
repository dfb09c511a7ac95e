"""The LM stack's serving path for every family (torch twin of
``repro.models``)."""
from .model import Model, build_model

__all__ = ["Model", "build_model"]
