"""B5, one-token GQA decode attention: the CUDA kernel
``repro_torch/csrc/decode_attn.cu`` on the card, its plain torch version on
the CPU."""
from .kernel import (build_library, decode_attn_cuda, decode_attn_op, launches,
                     reset_launches)
from .ops import block_size, decode_attention, live_blocks
from .ref import decode_attention_plain

__all__ = [
    "block_size",
    "build_library",
    "decode_attention",
    "decode_attention_plain",
    "decode_attn_cuda",
    "decode_attn_op",
    "launches",
    "live_blocks",
    "reset_launches",
]
