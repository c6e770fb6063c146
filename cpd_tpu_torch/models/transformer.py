"""Transformer encoder/decoder toolbox (port of cpd_tpu/models/transformer.py).

Pre-norm blocks of multi-head attention and a tanh-GELU MLP, an encoder
over tokens and a decoder of learned queries over a memory, with flax's
arithmetic: LayerNorm epsilon 1e-6, the query scaled by 1/sqrt(head_dim)
before the products, a mask that is True where a query may attend (others
get the dtype's lowest value before the softmax). Dropout runs only in
training mode.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` with qkv and output width ``dim``."""

    def __init__(self, dim: int, heads: int, dropout: float):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} is not a multiple of heads {heads}")
        self.heads, self.dropout = heads, dropout
        self.query, self.key, self.value, self.out = (nn.Linear(dim, dim) for _ in range(4))

    def forward(self, x, kv, mask=None):
        b, q_len, dim = x.shape
        hd = dim // self.heads
        q = self.query(x).reshape(b, q_len, self.heads, hd) / math.sqrt(hd)
        k = self.key(kv).reshape(b, kv.shape[1], self.heads, hd)
        v = self.value(kv).reshape(b, kv.shape[1], self.heads, hd)
        weights = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            weights = torch.where(mask, weights, torch.finfo(weights.dtype).min)
        weights = torch.softmax(weights, dim=-1)
        if self.training and self.dropout > 0.0:
            # one (q, k) keep mask for every sample and head, as flax draws it
            keep = torch.rand(weights.shape[-2:], device=weights.device) < 1.0 - self.dropout
            weights = weights * keep / (1.0 - self.dropout)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, q_len, dim))


class TransformerBlock(nn.Module):
    """Pre-norm attention block; ``with_context`` gives the keys and values
    their own LayerNorm (``ctx_norm``) for cross-attention."""

    def __init__(self, dim: int, heads: int = 4, mlp_ratio: int = 4, dropout: float = 0.1,
                 with_context: bool = False):
        super().__init__()
        self.dropout = dropout
        self.norm0 = nn.LayerNorm(dim, eps=1e-6)
        self.ctx_norm = nn.LayerNorm(dim, eps=1e-6) if with_context else None
        self.attn = MultiHeadAttention(dim, heads, dropout)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp0 = nn.Linear(dim, dim * mlp_ratio)
        self.mlp1 = nn.Linear(dim * mlp_ratio, dim)

    def forward(self, x, context=None, mask=None):
        h = self.norm0(x)
        if context is not None and self.ctx_norm is None:
            raise ValueError("a block built without with_context got a context")
        kv = h if context is None else self.ctx_norm(context)
        x = x + self.attn(h, kv, mask)
        h = F.gelu(self.mlp0(self.norm1(x)), approximate="tanh")
        h = F.dropout(h, self.dropout, self.training)
        return x + self.mlp1(h)


class TransformerEncoder(nn.Module):
    """``depth`` self-attention blocks over (B, N, C) tokens, then a
    LayerNorm; tokens of another width than ``dim`` (``in_channels``) pass a
    linear projection first."""

    def __init__(self, dim: int = 256, depth: int = 3, heads: int = 4, in_channels=None):
        super().__init__()
        self.proj = nn.Linear(in_channels, dim) if in_channels not in (None, dim) else None
        self.blocks = nn.ModuleList(TransformerBlock(dim, heads) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, tokens, mask=None):
        x = tokens if self.proj is None else self.proj(tokens)
        for block in self.blocks:
            x = block(x, mask=mask)
        return self.norm(x)


class TransformerDecoder(nn.Module):
    """``num_queries`` learned queries through ``depth`` pairs of a
    self-attention block and a cross-attention block over (B, N, dim)
    ``memory``, then a LayerNorm."""

    def __init__(self, dim: int = 256, depth: int = 3, heads: int = 4, num_queries: int = 100):
        super().__init__()
        self.queries = nn.Parameter(torch.randn(num_queries, dim) * 0.02)
        self.self_blocks = nn.ModuleList(TransformerBlock(dim, heads) for _ in range(depth))
        self.cross_blocks = nn.ModuleList(TransformerBlock(dim, heads, with_context=True)
                                          for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, memory, mask=None):
        x = self.queries[None].expand(memory.shape[0], -1, -1)
        for self_block, cross_block in zip(self.self_blocks, self.cross_blocks):
            x = self_block(x)
            x = cross_block(x, context=memory, mask=mask)
        return self.norm(x)
