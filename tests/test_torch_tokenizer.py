"""The port's CLIP tokenizer, ``encode_prompt`` and the loader's tokenizer
attachment held to the JAX package.

The tokenizer is a copy of the JAX one (pure Python): its ids must equal
JAX's exactly, on tests/test_utils.py's cases and on seeded random strings
over a toy byte-level vocabulary with merges. ``encode_prompt`` runs a tiny
CLIP text tower (SD2.1's vocabulary size, so the real BOS/EOS ids index it)
on both packages' weights, within tests/test_torch_models.py's CLIP bar.
"""

import json
import os

import numpy as np
import pytest
import torch

from genpercept_tpu.io.checkpoints import load_genpercept_checkpoint as jax_load
from genpercept_tpu.models import clip_text as j_clip
from genpercept_tpu.pipeline import GenPerceptModels as JModels
from genpercept_tpu.utils import tokenizer as jtok
from genpercept_tpu_torch.io.checkpoints import load_genpercept_checkpoint
from genpercept_tpu_torch.models import clip_text as t_clip
from genpercept_tpu_torch.pipeline import GenPerceptModels
from genpercept_tpu_torch.utils import tokenizer as ttok
from test_torch_checkpoint import ckpts  # noqa: F401  (module-scoped fixture)
from test_torch_models import ATOL, load, numpy_params

torch.set_num_threads(1)


def both(make):
    """The same tokenizer built by each package's module."""
    return make(jtok), make(ttok)


def assert_same_ids(pair, text, **kw):
    ref, ours = pair[0](text, **kw), pair[1](text, **kw)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape == (1, kw.get("context_length", 77))
    np.testing.assert_array_equal(ours, ref)


def toy_vocab():
    """Every byte's symbol, alone and word-final, a few merges, the specials."""
    be = ttok._byte_encoder()
    syms = sorted(set(be.values()))
    vocab = {s: i for i, s in enumerate(syms)}
    vocab.update({s + "</w>": len(syms) + i for i, s in enumerate(syms)})
    merges = [("h", "i</w>"), ("t", "h"), ("th", "e</w>"), ("a", "n"), ("an", "d</w>"),
              ("'", "s</w>"), ("e", "r"), ("er", "</w>")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab.update({"<|startoftext|>": ttok.BOS, "<|endoftext|>": ttok.EOS})
    return vocab, merges


def test_constants_and_empty_prompt_match_jax():
    assert (ttok.BOS, ttok.EOS, ttok.CONTEXT) == (jtok.BOS, jtok.EOS, jtok.CONTEXT)
    assert_same_ids(both(lambda m: m.empty_prompt_tokenizer(pad_token_id=0)), "")
    assert_same_ids(both(lambda m: m.empty_prompt_tokenizer(pad_token_id=7)), "ignored words")


def test_toy_vocab_cases_match_jax(tmp_path):
    """tests/test_utils.py:21-48: one merge, the from_dir round trip, the
    lowercasing and the truncation to 77."""
    vocab = {"h": 1, "i": 2, "i</w>": 3, "hi</w>": 4, "h</w>": 5,
             "<|startoftext|>": ttok.BOS, "<|endoftext|>": ttok.EOS}
    pair = both(lambda m: m.CLIPTokenizer(vocab, [("h", "i</w>")]))
    assert_same_ids(pair, "hi")
    assert pair[1]("hi")[0, :3].tolist() == [ttok.BOS, 4, ttok.EOS]
    d = tmp_path / "tokenizer"
    d.mkdir()
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version\nh i</w>\n")
    assert_same_ids(both(lambda m: m.CLIPTokenizer.from_dir(str(d))), "hi")
    letters = {chr(c): i for i, c in enumerate(range(ord("a"), ord("z") + 1))}
    letters.update({chr(c) + "</w>": 100 + i for i, c in enumerate(range(ord("a"), ord("z") + 1))})
    pair = both(lambda m: m.CLIPTokenizer(letters, []))
    assert_same_ids(pair, "A" * 200)
    assert pair[1]("A" * 200)[0, -1] == ttok.EOS
    assert_same_ids(pair, "Hello  World", context_length=16)


def test_random_strings_match_jax():
    vocab, merges = toy_vocab()
    pair = both(lambda m: m.CLIPTokenizer(vocab, merges, pad_token_id=3))
    rng = np.random.default_rng(0)
    alphabet = list("abcdefghijklmnopqrstuvwxyzTHEAND0123456789 .,!?'-_/") + \
        ["'s", "'ll", " the ", " and ", "hi", "er", "\t", "\n", "é", "ß", "中", "<|endoftext|>"]
    for _ in range(200):
        text = "".join(rng.choice(alphabet, size=int(rng.integers(0, 60))))
        assert_same_ids(pair, text)


@pytest.fixture(scope="module")
def clip_pair():
    kw = dict(vocab_size=49408, hidden_size=64, num_layers=2, num_heads=4,
              intermediate_size=128)
    jcfg, tcfg = j_clip.CLIPTextConfig(**kw), t_clip.CLIPTextConfig(**kw)
    p = numpy_params(j_clip.init_clip_text, jcfg, seed=21)
    return (p, jcfg), load(t_clip.CLIPTextModel(tcfg), p)


def test_encode_prompt_matches_jax(clip_pair):
    (p, jcfg), clip = clip_pair
    vocab, merges = toy_vocab()
    ref = JModels(unet={}, vae={}, clip=p, clip_cfg=jcfg,
                  tokenizer=jtok.CLIPTokenizer(vocab, merges))
    ours = GenPerceptModels(unet=None, vae=None, clip=clip,
                            tokenizer=ttok.CLIPTokenizer(vocab, merges))
    for prompt in ("", "the depth of an indoor scene", "Hi, THERE's 42 hands!"):
        got = ours.encode_prompt(prompt)
        assert got.shape == (1, 77, 64)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref.encode_prompt(prompt)), atol=ATOL)
    # the empty prompt is the cached embedding
    assert ours.encode_prompt("") is ours.get_text_embed()


def test_encode_prompt_refuses_what_jax_refuses(clip_pair):
    _, clip = clip_pair
    embed = torch.zeros(1, 77, 64)
    no_tok = GenPerceptModels(unet=None, vae=None, clip=clip, text_embed=embed)
    assert no_tok.encode_prompt("") is embed
    with pytest.raises(ValueError, match="tokenizer"):
        no_tok.encode_prompt("a prompt")
    no_clip = GenPerceptModels(unet=None, vae=None, text_embed=embed,
                               tokenizer=ttok.empty_prompt_tokenizer())
    with pytest.raises(ValueError, match="CLIP"):
        no_clip.encode_prompt("a prompt")


def write_tokenizer(root, vocab, merges):
    d = root / "tokenizer"
    d.mkdir(parents=True)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version\n" + "".join(f"{a} {b}\n" for a, b in merges))


@pytest.mark.parametrize("where", ["checkpoint", "base", "none"])
def test_loader_attaches_a_tokenizer_as_jax(ckpts, tmp_path, where):  # noqa: F811
    """tokenizer/ beside unet/ and vae/, or in the base checkpoint of a
    unet-only directory: both loaders attach the same tokenizer (or none)."""
    plain, _ = ckpts["plain"]
    unet_only, _ = ckpts["unet_only"]
    root = tmp_path / "ckpt"
    root.mkdir()
    for sub in ("unet", "vae", "empty_text_embed.npy"):
        os.symlink(plain / sub, root / sub)
    vocab, merges = toy_vocab()
    if where != "none":
        write_tokenizer(root, vocab, merges)
    path, base = (str(root), None) if where == "checkpoint" else (str(unet_only), str(root))
    ours = load_genpercept_checkpoint(path, base_ckpt_dir=base, device="cpu")
    ref = jax_load(path, base_ckpt_dir=base)
    if where == "none":
        assert ours.tokenizer is None and ref.tokenizer is None
        return
    assert isinstance(ours.tokenizer, ttok.CLIPTokenizer)
    for text in ("the hands", "an indoor scene's depth"):
        np.testing.assert_array_equal(ours.tokenizer(text), ref.tokenizer(text))
