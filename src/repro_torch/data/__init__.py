"""Synthetic, stateless token pipeline (torch port of ``repro.data``)."""
from .pipeline import SyntheticLM, TokenStream, pack_documents, sharded_batches

__all__ = ["SyntheticLM", "TokenStream", "pack_documents", "sharded_batches"]
