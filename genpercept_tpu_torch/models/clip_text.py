"""CLIP text encoder (SD2.1's OpenCLIP-ViT/H text tower) as an nn.Module.

Counterpart of ``genpercept_tpu/models/clip_text.py``. The pipeline encodes
one prompt, the empty string, and caches the (1, 77, hidden) embedding.
State-dict keys are the transformers names under ``text_model.``
(embeddings.token_embedding.weight, encoder.layers.N.self_attn.q_proj...).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from genpercept_tpu_torch.models.layers import Norm, dense
from genpercept_tpu_torch.ops import layer_norm

BOS_TOKEN_ID = 49406
EOS_TOKEN_ID = 49407
# stabilityai/stable-diffusion-2* tokenizer pads with "!" (id 0)
SD21_PAD_TOKEN_ID = 0


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    num_layers: int = 23
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "gelu"  # SD2.1; SD1.x uses quick_gelu
    bos_token_id: int = BOS_TOKEN_ID
    eos_token_id: int = EOS_TOKEN_ID
    pad_token_id: int = SD21_PAD_TOKEN_ID


SD21_CLIP_TEXT = CLIPTextConfig()


def empty_prompt_ids(cfg: CLIPTextConfig = SD21_CLIP_TEXT,
                     device=None) -> torch.Tensor:
    """Token ids of "" : [BOS, EOS, PAD...], shape (1, 77)."""
    ids = [cfg.bos_token_id, cfg.eos_token_id] + [cfg.pad_token_id] * (
        cfg.max_position_embeddings - 2)
    return torch.tensor([ids], dtype=torch.long, device=device)


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)


class _SelfAttention(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.q_proj = nn.Linear(c, c)
        self.k_proj = nn.Linear(c, c)
        self.v_proj = nn.Linear(c, c)
        self.out_proj = nn.Linear(c, c)


class _MLP(nn.Module):
    def __init__(self, c: int, inter: int):
        super().__init__()
        self.fc1 = nn.Linear(c, inter)
        self.fc2 = nn.Linear(inter, c)


class _Layer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        c = cfg.hidden_size
        self.layer_norm1 = Norm(c)
        self.self_attn = _SelfAttention(c)
        self.layer_norm2 = Norm(c)
        self.mlp = _MLP(c, cfg.intermediate_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([_Layer(cfg) for _ in range(cfg.num_layers)])


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig = SD21_CLIP_TEXT):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = Norm(cfg.hidden_size)


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "gelu":
        return F.gelu(x)
    if kind == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    raise ValueError(kind)


def _causal_self_attention(p: _SelfAttention, x: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, c = x.shape
    d = c // heads
    q = dense(p.q_proj, x).reshape(b, s, heads, d)
    k = dense(p.k_proj, x).reshape(b, s, heads, d)
    v = dense(p.v_proj, x).reshape(b, s, heads, d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    logits = logits.masked_fill(~causal, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, c)
    return dense(p.out_proj, o)


def clip_text_apply(clip: CLIPTextModel, input_ids: torch.Tensor) -> torch.Tensor:
    """input_ids: (B, 77) -> last_hidden_state (B, 77, hidden)."""
    cfg = clip.cfg
    emb = clip.embeddings
    x = emb.token_embedding.weight[input_ids]
    x = x + emb.position_embedding.weight[None, : x.shape[1]]
    for lyr in clip.encoder.layers:
        h = layer_norm(x, lyr.layer_norm1.weight, lyr.layer_norm1.bias, cfg.layer_norm_eps)
        x = x + _causal_self_attention(lyr.self_attn, h, cfg.num_heads)
        h = layer_norm(x, lyr.layer_norm2.weight, lyr.layer_norm2.bias, cfg.layer_norm_eps)
        h = _act(dense(lyr.mlp.fc1, h), cfg.hidden_act)
        x = x + dense(lyr.mlp.fc2, h)
    return layer_norm(x, clip.final_layer_norm.weight, clip.final_layer_norm.bias,
                      cfg.layer_norm_eps)
