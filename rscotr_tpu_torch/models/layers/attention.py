"""Multi-head attention with DETR-style masking (PyTorch counterpart of
rscotr_tpu/models/layers/attention.py).

Explicit matmuls + softmax over parameters laid out as mmcv's
``MultiheadAttention`` wrapper of ``torch.nn.MultiheadAttention``: keys
``attn.in_proj_weight`` (rows [q; k; v]), ``attn.in_proj_bias`` and
``attn.out_proj``. Batch-first (B, N, C). Self-attention (the DINO
decoder's, the Mask2Former decoder's) and cross-attention (the Mask2Former
decoder's, ``key`` / ``value`` / ``key_pos``). Masks follow torch:
``attn_mask`` bool (Nq, Nk) or (B*heads, Nq, Nk), True = not allowed;
``key_padding_mask`` bool (B, Nk), True = padded. An all-masked row falls
back to uniform attention, as in the JAX module. Under tensor parallelism
(``parallel/tp.py``) the fused projection is held as (3, C, C) sharded by
heads and each rank attends with its own heads; ``out_proj`` sums them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from rscotr_tpu_torch.models.layers.common import (Linear, constant_,
                                                   lecun_normal_)

NEG_INF = -1e9


class _InOutProj(nn.Module):
    """Parameter holder with torch.nn.MultiheadAttention's names."""

    def __init__(self, embed_dims: int, dtype, device):
        super().__init__()
        C = embed_dims
        self.in_proj_weight = nn.Parameter(torch.empty(3 * C, C,
                                                       device=device))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * C, device=device))
        self.out_proj = Linear(C, C, dtype=dtype, device=device)

    def _init_params(self, g):
        lecun_normal_(self.in_proj_weight, self.in_proj_weight.shape[1], g)
        constant_(self.in_proj_bias, 0.0)


class MultiheadAttention(nn.Module):
    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.embed_dims = embed_dims
        self.num_heads = num_heads
        self.dtype = dtype
        self.attn = _InOutProj(embed_dims, dtype, device)

    def _proj(self, x, i):
        C, dt = self.embed_dims, self.dtype
        w, b = self.attn.in_proj_weight, self.attn.in_proj_bias
        if w.dim() == 3:
            # tensor parallelism (parallel/tp.py): (3, C, C) sharded by
            # heads; x replicated in, this rank's heads out
            from torch.distributed.tensor import DTensor, Replicate
            xd = DTensor.from_local(x.to(dt), w.device_mesh, [Replicate()],
                                    run_check=False)
            return F.linear(xd, w[i].to(dt), b[i].to(dt)).to_local()
        w = w[i * C:(i + 1) * C].to(dt)
        b = b[i * C:(i + 1) * C].to(dt)
        return F.linear(x.to(dt), w, b)

    def forward(self, query, key=None, value=None, identity=None,
                query_pos=None, key_pos=None, attn_mask=None,
                key_padding_mask=None):
        """Attention of ``query`` (B, Nq, C) over ``key`` (B, Nk, C; default
        ``query``). ``query_pos`` is added to the queries, ``key_pos`` to
        the keys (default ``query_pos`` when the key is the query); the
        value projection reads ``value`` (default ``key``) without its pos.
        Returns ``identity`` (default ``query``) + the output projection."""
        if key is None:
            key = query
        if value is None:
            value = key
        if identity is None:
            identity = query
        if key_pos is None and key is query:
            key_pos = query_pos
        q = query + query_pos if query_pos is not None else query
        k = key + key_pos if key_pos is not None else key
        B, Nq, C = q.shape
        Nk = k.shape[1]
        hd = C // self.num_heads
        qp = self._proj(q, 0)
        # this rank's heads under tensor parallelism: [h0, h0 + H)
        H = qp.shape[-1] // hd
        h0 = _local_rank(self.attn.in_proj_weight) * H
        qp = qp.reshape(B, Nq, H, hd).transpose(1, 2)
        kp = self._proj(k, 1).reshape(B, Nk, H, hd).transpose(1, 2)
        vp = self._proj(value, 2).reshape(B, Nk, H, hd).transpose(1, 2)

        logits = scaled_logits(qp, kp)
        if attn_mask is not None or key_padding_mask is not None:
            if attn_mask is not None:
                m = (attn_mask[None, None] if attn_mask.dim() == 2
                     else attn_mask.reshape(B, -1, Nq, Nk)[:, h0:h0 + H])
                logits = logits.masked_fill(m, NEG_INF)
            if key_padding_mask is not None:
                logits = logits.masked_fill(
                    key_padding_mask[:, None, None, :], NEG_INF)
            all_masked = (logits <= NEG_INF / 2).all(-1, keepdim=True)
            logits = logits.masked_fill(all_masked, 0.0)
        attn = torch.softmax(logits, dim=-1)
        out = torch.matmul(attn, vp).transpose(1, 2).reshape(B, Nq, H * hd)
        return identity + self.attn.out_proj(out)


def scaled_logits(qp: torch.Tensor, kp: torch.Tensor) -> torch.Tensor:
    """qp kp^T / sqrt(head width), the root taken in qp's dtype on qp's
    device. Its operand is filled there: one copied from host memory would
    synchronise the stream (and so end a CUDA graph's capture), and a host
    scalar divisor would divide on the card by multiplying with its
    reciprocal, which can miss the quotient by a bit."""
    root = torch.sqrt(torch.full((), float(qp.shape[-1]), dtype=qp.dtype,
                                 device=qp.device))
    return torch.matmul(qp, kp.transpose(-1, -2)) / root


def _local_rank(w: torch.Tensor) -> int:
    """This rank's index on the mesh a tensor-parallel weight is sharded
    over (0 for a plain tensor)."""
    mesh = getattr(w, "device_mesh", None)
    return mesh.get_local_rank() if mesh is not None else 0
