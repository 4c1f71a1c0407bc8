"""The port's native tokenizer (``sparsify_clip_tpu_torch.text.native``)
against the JAX package's, on the CPU.

The C++ source is a byte-for-byte copy of the JAX package's, built into
the port's ``_build/``; its ids are held equal to the JAX
``NativeCLIPTokenizer``'s to the bit (tolerance 0), the counterpart the
JAX ``tokenizer: auto`` picks, on ASCII captions, HTML entities and
non-ASCII text.  Its known gap to the Python tokenizer is asserted on the
entity strings.  The route selection (``_select_tokenizer``) is held to
the JAX one's, with the build made to fail.
"""

import ctypes
import dataclasses
import os
import pickle

import numpy as np
import pytest

from sparsify_clip_tpu.data import pipeline as jax_pipeline
from sparsify_clip_tpu.data.synthetic import make_caption
from sparsify_clip_tpu.text import native as jax_native
from sparsify_clip_tpu.text.tokenizer import CLIPTokenizer as JaxTokenizer
from sparsify_clip_tpu_torch.config import ExperimentConfig
from sparsify_clip_tpu_torch.data import pipeline
from sparsify_clip_tpu_torch.text import get_tokenizer, native
from sparsify_clip_tpu_torch.text.tokenizer import SUBSET_VOCAB_PATH
from sparsify_clip_tpu_torch.utils import native_build

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
ENTITIES = ["&gt", "&#0", "a &amp; b", "&lt;tag&gt;", "&amp;amp;", "5 &gt 3 &#62; 2"]
NON_ASCII = ["naïve café", "Ünïcode", "x² y³", "Привет мир", "日本語のテキスト",
             "the café’s", "١٢٣ numbers", "emoji 😀 ok", "ǅ", "ſ"]


@pytest.fixture(scope="module")
def tokenizers():
    return (native.NativeCLIPTokenizer(SUBSET_VOCAB_PATH),
            jax_native.NativeCLIPTokenizer(SUBSET_VOCAB_PATH))


def test_the_source_is_the_jax_packages_byte_for_byte():
    with open(os.path.join(REPO, "native", "tokenizer", "clip_bpe.cpp"), "rb") as fh:
        assert native.SOURCE.read_bytes() == fh.read()


@pytest.mark.parametrize("kind", ["captions", "entities", "non_ascii"])
def test_ids_equal_the_jax_native_tokenizers(tokenizers, kind):
    port, jax_tok = tokenizers
    if kind == "captions":
        rng = np.random.default_rng(0)
        texts = [make_caption(rng) for _ in range(300)] + [
            "", "a" * 300, "word " * 100, "don't won't can't we'll they're i'm you've she'd",
            "UPPER Case MiXeD", "hello,world...  spaced   out\ttabs"]
    else:
        texts = ENTITIES if kind == "entities" else NON_ASCII
    got, want = port(texts), jax_tok(texts)
    assert got.dtype == np.int32 and got.shape == (len(texts), 77)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port(texts, context_length=16), jax_tok(texts, context_length=16))


def test_the_gap_to_the_python_tokenizer(tokenizers):
    """No html.unescape in the C++ core: every entity string tokenizes
    otherwise than in the Python tokenizers (the port's and the JAX
    package's, which agree); ASCII captions tokenize the same."""
    port, _ = tokenizers
    python, jax_python = get_tokenizer(bpe_path=SUBSET_VOCAB_PATH), JaxTokenizer(SUBSET_VOCAB_PATH)
    for text in ENTITIES:
        np.testing.assert_array_equal(python(text), jax_python(text))
        assert not np.array_equal(port(text), python(text)), text
    rng = np.random.default_rng(1)
    captions = [make_caption(rng) for _ in range(200)]
    np.testing.assert_array_equal(port(captions), python(captions))
    differ = [t for t in NON_ASCII if not np.array_equal(port(t), python(t))]
    assert "Привет мир" in differ and "naïve café" not in differ


def test_the_build_lands_in_the_ports_build_dir(monkeypatch):
    loaded = []
    cdll = ctypes.CDLL

    def recording(path, *args, **kwargs):
        loaded.append(str(path))
        return cdll(path, *args, **kwargs)

    monkeypatch.setattr(native.ctypes, "CDLL", recording)
    tok = native.NativeCLIPTokenizer()
    assert len(loaded) == 1 and os.path.dirname(loaded[0]) == str(native_build.BUILD_DIR)
    assert "native" + os.sep + "tokenizer" not in loaded[0]
    assert os.path.basename(loaded[0]).startswith("libclip_bpe_")
    assert native.build_library() == native_build.library_path(native.SOURCE, native.CXXFLAGS, ())
    assert tok.backend == "native" and get_tokenizer().backend == "python"


def test_pickles_by_rebuilding(tokenizers):
    port, _ = tokenizers
    clone = pickle.loads(pickle.dumps(port))
    assert clone._handle != port._handle
    texts = ["a photo of a dog", "&gt"]
    np.testing.assert_array_equal(clone(texts), port(texts))


def test_no_temporary_merges_file_is_left(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    native.NativeCLIPTokenizer(SUBSET_VOCAB_PATH)
    assert os.listdir(tmp_path) == []


def _config(**fields):
    return ExperimentConfig.from_dict(dict(model="tiny-test", **fields))


def test_routes_select_as_the_jax_pipeline():
    for choice, backend in (("native", "native"), ("auto", "native"), ("python", "python")):
        port = pipeline._select_tokenizer(_config(tokenizer=choice))
        want = jax_pipeline._select_tokenizer(
            jax_pipeline.ExperimentConfig.from_dict(dict(model="tiny-test", tokenizer=choice)))
        assert port.backend == backend
        assert type(want).__name__ == type(port).__name__
        np.testing.assert_array_equal(port(["a cat on a mat"]), want(["a cat on a mat"]))


def test_a_failed_build_raises_for_native_and_falls_back_for_auto(tmp_path, monkeypatch):
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CXX", raising=False)
    assert native.ensure_built() is None
    with pytest.raises(RuntimeError, match="native tokenizer library unavailable.*C\\+\\+ compiler"):
        pipeline._select_tokenizer(_config(tokenizer="native"))
    assert pipeline._select_tokenizer(_config(tokenizer="auto")).backend == "python"
    config = dataclasses.replace(_config(tokenizer="auto"), dataset="synthetic", batch_size=4,
                                 num_train_samples=8, num_test_samples=4)
    train, test = pipeline.dataset_loader(config, image_size=16)
    assert pipeline.routes(train)["tokenizer"] == pipeline.routes(test)["tokenizer"] == "python"
    assert not (tmp_path / "_build").exists() or os.listdir(tmp_path / "_build") == []
