"""Minimal CLIP BPE tokenizer (host-side, pure Python).

A copy of ``genpercept_tpu/utils/tokenizer.py``, which imports no jax.

GenPercept only ever encodes the empty prompt (cached embedding), but the
reference exposes `--prompt` on infer.py; this tokenizer supports that when
the checkpoint ships its tokenizer files (`tokenizer/vocab.json` +
`tokenizer/merges.txt`, as the published SD2.1 checkpoints do). Implements
the standard CLIP scheme: NFC-ish whitespace cleanup + lowercase, GPT-2 byte
encoder, BPE with end-of-word `</w>` marker, bos/eos wrapping, pad to 77.

No network access: if the vocab files are absent, only the empty prompt is
representable (ids [bos, eos, pad...]).
"""

from __future__ import annotations

import functools
import json
import os.path as osp
import re
from typing import Dict, List, Optional, Tuple

BOS = 49406
EOS = 49407
CONTEXT = 77

_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"
    if False  # \p classes need regex module; use the ASCII-safe equivalent
    else r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
    re.IGNORECASE,
)


@functools.lru_cache()
def _byte_encoder() -> Dict[int, str]:
    """GPT-2 byte -> unicode mapping (printable, reversible)."""
    bs = list(range(ord("!"), ord("~") + 1)) + \
         list(range(ord("\xa1"), ord("\xac") + 1)) + \
         list(range(ord("\xae"), ord("\xff") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class CLIPTokenizer:
    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 pad_token_id: int = 0):
        self.vocab = vocab
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.pad_token_id = pad_token_id
        self._cache: Dict[str, List[str]] = {}

    @classmethod
    def from_dir(cls, tokenizer_dir: str, pad_token_id: int = 0) -> "CLIPTokenizer":
        with open(osp.join(tokenizer_dir, "vocab.json")) as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(osp.join(tokenizer_dir, "merges.txt")) as f:
            for line in f.read().split("\n")[1:]:
                parts = line.split()
                if len(parts) == 2:
                    merges.append((parts[0], parts[1]))
        return cls(vocab, merges, pad_token_id)

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        text = re.sub(r"\s+", " ", text.strip()).lower()
        be = _byte_encoder()
        ids: List[int] = []
        for tok in _PAT.findall(text):
            tok = "".join(be[b] for b in tok.encode("utf-8"))
            ids.extend(self.vocab[p] for p in self._bpe(tok) if p in self.vocab)
        return ids

    def __call__(self, text: str, context_length: int = CONTEXT):
        """-> (1, 77) int ids: [BOS, tokens..., EOS, PAD...] (truncated)."""
        import numpy as np

        ids = [BOS] + self.encode(text)[: context_length - 2] + [EOS]
        ids = ids + [self.pad_token_id] * (context_length - len(ids))
        return np.asarray([ids], np.int32)


def empty_prompt_tokenizer(pad_token_id: int = 0) -> "CLIPTokenizer":
    """Tokenizer usable without vocab files (empty prompt only)."""
    return CLIPTokenizer({}, [], pad_token_id)


def load_tokenizer(ckpt_dir: str) -> Optional[CLIPTokenizer]:
    tok_dir = osp.join(ckpt_dir, "tokenizer")
    if osp.isfile(osp.join(tok_dir, "vocab.json")):
        return CLIPTokenizer.from_dir(tok_dir)
    return None
