"""The port's tokenizer (``sparsify_clip_tpu_torch.text``, no ``regex``)
against the JAX package's, on the CPU: token ids exactly equal on the
subset vocab, over text drawn from every code point assigned in the
interpreter's Unicode version, html entities and U+001C-U+001F; the
pre-tokenizer against ``regex.findall`` of the JAX pattern; the vocab
copy byte for byte; raw strings through ``CLIPEncoder.encode_texts`` and
the server's ``submit_text``.  Every comparison is exact (tolerance 0).
"""

import os
import sys
import unicodedata

import numpy as np
import pytest
import regex
import torch
from hypothesis import given, settings, strategies as st

from sparsify_clip_tpu.text import tokenizer as jax_tok
from sparsify_clip_tpu_torch.text import tokenizer as port_tok

# hypothesis's own tables may be newer than this interpreter's: keep the
# code points assigned in this interpreter's Unicode (the card's is the same)
ASSIGNED = st.characters(exclude_categories=("Cn", "Cs")).filter(
    lambda c: unicodedata.category(c) not in ("Cn", "Cs"))
PIECES = st.sampled_from([
    "&gt", "&gt;", "&#0", "&#0;", "&amp;amp;", "&amp;gt;", "&lt;3", "&#x27;", "&nbsp;",
    "\x1c", "\x1d", "\x1e", "\x1f", "\x85", "\xa0", "　", "ͅ", "'S", "'ſ", "ſ",
    "<|startoftext|>", "<|endoftext|>", "<|ENDOFTEXT|>", "'ll", "'Re", "  ", "\t\n", "A dog",
    "İ", "K", "Ⅻ", "٣", "x²", "ǅ", "ﬅ", "🐈", "é",
])
TEXT = st.lists(st.one_of(ASSIGNED, PIECES, st.text(ASSIGNED, max_size=4)),
                max_size=24).map("".join)


@pytest.fixture(scope="module")
def tokenizers():
    path = port_tok.SUBSET_VOCAB_PATH
    return jax_tok.CLIPTokenizer(jax_tok.SUBSET_VOCAB_PATH), port_tok.CLIPTokenizer(path)


def test_the_vocab_copy_is_byte_identical():
    with open(jax_tok.SUBSET_VOCAB_PATH, "rb") as a, open(port_tok.SUBSET_VOCAB_PATH, "rb") as b:
        assert a.read() == b.read()


def test_default_bpe_path_order(tmp_path, monkeypatch):
    monkeypatch.delenv("CLIP_BPE_PATH", raising=False)
    assert port_tok.default_bpe_path() == port_tok.SUBSET_VOCAB_PATH
    merges = tmp_path / "merges.txt"
    merges.write_text("#version\nh e</w>\n")
    monkeypatch.setenv("CLIP_BPE_PATH", str(merges))
    assert port_tok.default_bpe_path() == str(merges)
    monkeypatch.setenv("CLIP_BPE_PATH", str(tmp_path / "absent.txt"))
    assert port_tok.default_bpe_path() == port_tok.SUBSET_VOCAB_PATH
    tok = port_tok.CLIPTokenizer(str(merges))
    assert tok.vocab_kind == "openai" and tok.encode("he") == [512]


@settings(max_examples=300, deadline=None)
@given(TEXT)
def test_pre_tokenizer_equals_regex_findall(text):
    text = text.lower()
    assert port_tok.pre_tokenize(text) == regex.findall(jax_tok._PAT, text)


def test_pre_tokenizer_classes_on_every_assigned_code_point():
    """Every code point assigned in this interpreter's Unicode, alone,
    after an apostrophe and between a letter and a digit, in runs of
    4096 code points."""
    assigned = [chr(cp) for cp in range(sys.maxunicode + 1)
                if unicodedata.category(chr(cp)) not in ("Cn", "Cs")]
    for k in range(0, len(assigned), 4096):
        text = " ".join(f"{c} '{c} a{c}1" for c in assigned[k:k + 4096])
        assert port_tok.pre_tokenize(text) == regex.findall(jax_tok._PAT, text), hex(ord(assigned[k]))


@settings(max_examples=300, deadline=None)
@given(TEXT)
def test_token_ids_equal_the_jax_tokenizer(tokenizers, text):
    jt, pt = tokenizers
    assert pt.encode(text) == jt.encode(text)


@pytest.mark.parametrize("context", [77, 8])
def test_batch_call_equals_the_jax_tokenizer(tokenizers, context):
    jt, pt = tokenizers
    texts = ["a dog riding a surfboard on the beach", "", "&amp;gt; 3 cats\x1c\x1fhere",
             "Über-long " * 20, "<|endoftext|> inside", "ｆｕｌｌ ｗｉｄｔｈ ４２"]
    got, want = pt(texts, context_length=context), jt(texts, context_length=context)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    for row in got:
        assert row[0] == pt.sot_id and pt.eot_id in row
    assert pt.decode(pt.encode("a dog riding")) == jt.decode(jt.encode("a dog riding"))


def test_get_tokenizer_is_cached_and_uses_the_subset_vocab(monkeypatch):
    monkeypatch.delenv("CLIP_BPE_PATH", raising=False)
    port_tok.get_tokenizer.cache_clear()
    tok = port_tok.get_tokenizer("ViT-B-32")
    assert tok is port_tok.get_tokenizer("ViT-B-32")
    assert tok.vocab_kind == "subset"


def test_raw_strings_serve_through_the_tokenizer():
    from sparsify_clip_tpu_torch.inference import CLIPEncoder
    from sparsify_clip_tpu_torch.models.clip import create_model
    from sparsify_clip_tpu_torch.serving import BatchingEncoderServer

    tok = port_tok.CLIPTokenizer()
    model = create_model("tiny-test", device="cpu", seed=0)
    encoder = CLIPEncoder(model, tok)
    texts = ["a cat sitting on a bench", "a kite eating snow"]
    direct = encoder.encode_texts(texts)
    torch.testing.assert_close(direct, encoder.encode_tokens(tok(texts)), rtol=0, atol=0)
    with BatchingEncoderServer(encoder, max_batch=2, max_wait_ms=50.0) as server:
        futures = [server.submit_text(t) for t in texts]
        served = np.stack([f.result(timeout=60) for f in futures])
    # the same rows in a batch of the same size: the same embeddings
    np.testing.assert_allclose(served, direct.numpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="tokenizer"):
        CLIPEncoder(model).encode_texts(texts)
    with BatchingEncoderServer(CLIPEncoder(model), max_batch=2) as server:
        with pytest.raises(ValueError, match="tokenizer"):
            server.submit_text("a dog")
