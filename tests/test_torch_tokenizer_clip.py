"""The port's CLIP BPE tokenizer against ``madtp_tpu.data.tokenizer_clip`` on
the vendored merge table: equal ids from ``clip_tokenize`` and equal
decodes on a fixed list of texts (ASCII captions with contractions and
punctuation runs, HTML entities, letters of several scripts with combining
marks, ``No``/``Nl`` numbers, emoji, the empty string, a text longer than
77 tokens), the pre-tokenizer against the JAX pattern's ``findall`` on
every assigned code point, the same vocabulary, truncation, and an import
with ``regex`` blocked (the card's machine has no ``regex``)."""

import pathlib
import subprocess
import sys
import unicodedata

import numpy as np
import pytest

from madtp_tpu.data import tokenizer_clip as J
from madtp_tpu_torch.data import tokenizer_clip as T

REPO = pathlib.Path(__file__).resolve().parent.parent
TEXTS = [
    "A dog's toy isn't what they'd've wanted... !!! ?! --- (really?)",
    "Two men riding horses on a beach, while a woman's watching; it'll rain.",
    "I'M HERE, YOU'RE THERE & WE'LL MEET",
    "Tom &amp;amp; Jerry &lt;3 &quot;hi&quot; &#39;quoted&#39; &eacute;",
    "Ελληνικά, русский, 日本語の文, עברית, العربية, 한국어",
    "café naïve Zoë aͅb",
    "x² + ½ = Ⅻ ⅻ ٣ 42 3.14 ⑦",
    "🐶🐱 emoji 👍🏽 ok 👨‍👩‍👧 flags 🇫🇷",
    "",
    "   \t\n  ",
    " ".join(f"word{i} and more" for i in range(40)),
    "<|endoftext|> hi <|startoftext|>x<|ENDOFTEXT|> itſs 'ſ",
]


@pytest.fixture(scope="module")
def toks():
    return J.ClipBPETokenizer(), T.ClipBPETokenizer()


def test_vocabulary_equal(toks):
    jt, t = toks
    assert t.encoder == jt.encoder and t.bpe_ranks == jt.bpe_ranks
    assert (t.sot_token, t.eot_token) == (jt.sot_token, jt.eot_token) == (49406, 49407)
    assert len(t.encoder) == 49408


@pytest.mark.parametrize("text", TEXTS, ids=range(len(TEXTS)))
def test_clip_tokenize_and_decode_match_jax(toks, text):
    jt, t = toks
    got, want = T.clip_tokenize(t, [text]), J.clip_tokenize(jt, [text])
    assert got.dtype == want.dtype == np.int32 and got.shape == (1, 77)
    np.testing.assert_array_equal(got, want)
    assert t.encode(text) == jt.encode(text)
    assert t.decode(t.encode(text)) == jt.decode(jt.encode(text))


def test_batch_and_truncation_match_jax(toks):
    jt, t = toks
    got = T.clip_tokenize(t, TEXTS, context_length=32)
    np.testing.assert_array_equal(got, J.clip_tokenize(jt, TEXTS, context_length=32))
    long = TEXTS[10]
    assert len(t.encode(long)) > 77
    row = T.clip_tokenize(t, [long])[0]
    assert row[0] == t.sot_token and row[-1] == t.eot_token and (row != 0).all()
    for mod, tok in ((T, t), (J, jt)):
        with pytest.raises(RuntimeError, match="too long"):
            mod.clip_tokenize(tok, [long], truncate=False)


def test_pre_tokenize_matches_the_pattern_on_every_code_point(toks):
    """Every code point assigned in this Python's Unicode database, run
    together, lowercased, and separated by spaces or by apostrophes: the
    scanner splits as ``regex``'s ``findall`` does."""
    jt, _ = toks
    chars = "".join(chr(c) for c in range(sys.maxunicode + 1)
                    if not 0xD800 <= c < 0xE000 and unicodedata.category(chr(c)) != "Cn")
    for text in (chars, chars.lower(), " ".join(chars), "'".join(chars)):
        assert T.pre_tokenize(text) == jt.pat.findall(text)


def test_vocab_path_override(toks):
    t = T.ClipBPETokenizer(vocab_path=str(REPO / "madtp_tpu/data/assets/bpe_simple_vocab_16e6.txt.gz"))
    assert t.encode(TEXTS[0]) == toks[1].encode(TEXTS[0])


def test_imports_without_regex():
    code = ("import sys\n"
            "sys.modules['regex'] = None\n"  # any `import regex` now raises ImportError
            "from madtp_tpu_torch.data.tokenizer_clip import ClipBPETokenizer, clip_tokenize\n"
            "t = ClipBPETokenizer()\n"
            "print(clip_tokenize(t, ['a dog'])[0, :4].tolist())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == str(J.clip_tokenize(J.ClipBPETokenizer(), ["a dog"])[0, :4]
                                      .tolist())
