"""The chunked attention's plain reference for the tests of its backward
(not a test file; it imports no JAX, so the card tests use it too).
"""
import torch

from repro_torch.models.flash import NEG_INF


def dense_plain(q, k, v, qpos, kpos, window, causal, scale):
    """The masked softmax over every (query, key) pair, in f32."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    qg = q.float().reshape(b, sq, kv, h // kv, hd)
    s = torch.einsum("bqkgh,btkh->bkgqt", qg, k.float()) * scale
    qp, kp = qpos[:, :, None], kpos[:, None, :]
    valid = kp >= 0
    if causal:
        valid = valid & (kp <= qp)
        if window:
            valid = valid & (kp > qp - window)
    s = s.masked_fill(~valid[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkh->bqkgh", p, v.float())
    return o.reshape(b, sq, h, hd)
