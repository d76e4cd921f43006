"""The port's ``tokenizer.json`` interpreter (``alg_tpu_torch/io/hf_tokenizer.py``)
against the Rust ``tokenizers`` library on the fixtures of
``tests/test_hf_tokenizer.py`` (T5/UMT5 Unigram + Metaspace, Llama-3 BPE,
CLIP BPE, GPT-2 byte level, WordLevel with an added ``<image>``), against
``alg_tpu``'s copy on the three tiny checkpoints' tokenizers, and without
the ``regex`` package: the T5 path works on ASCII text, and what needs
``regex`` raises an error that names it."""

import base64
import os
import subprocess
import sys

import numpy as np
import pytest

tokenizers = pytest.importorskip("tokenizers")
from tokenizers import AddedToken, Tokenizer, models, pre_tokenizers  # noqa: E402

from alg_tpu.io import hf_tokenizer as JT  # noqa: E402

from alg_tpu_torch.io import hf_tokenizer as TT  # noqa: E402

from test_hf_tokenizer import TEXTS, _clip_style, _darts_unit, _llama3_style, _t5_style  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import make_tiny_checkpoint  # noqa: E402

from torch_port_common import one_thread


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t5_with_image():
    tok = _t5_style()
    tok.add_special_tokens([AddedToken("<image>", normalized=False, special=True)])
    return tok


def _gpt2_style():
    base = [chr(c) for c in range(33, 127)] + ["Ġ", "Ċ", "ĉ", "Ĥ", "ł", "Ń"]
    vocab, merges = {}, []
    for ch in base:
        vocab[ch] = len(vocab)
    for pair, tok in [(("Ġ", "a"), "Ġa"), (("l", "o"), "lo"), (("Ġa", "nd"), "Ġand"), (("n", "d"), "nd")]:
        merges.append(pair)
        vocab[tok] = len(vocab)
    for sym in TT._byte_encoder().values():
        vocab.setdefault(sym, len(vocab))
    tok = Tokenizer(models.BPE(vocab=vocab, merges=merges))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=True, use_regex=True)
    return tok


def _wordlevel():
    words = {"<pad>": 0, "</s>": 1, "<unk>": 2, "a": 3, "red": 4, "bus": 5, "<image>": 6}
    tok = Tokenizer(models.WordLevel(words, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.add_special_tokens(["<image>"])
    return tok


IMAGE_TEXTS = ["<image> Hello world", "a<image>b", "no image", "<image><image>", "<image>"]
CASES = {
    "t5-unigram": (_t5_style, TEXTS),
    "unigram-byte-fallback-prepend-first": (lambda: _t5_style(byte_fallback=True, prepend_scheme="first"), TEXTS),
    "added-special-image": (_t5_with_image, IMAGE_TEXTS),
    "llama3-bpe": (_llama3_style, TEXTS),
    "clip-bpe": (_clip_style, TEXTS),
    "gpt2-byte-level": (_gpt2_style, TEXTS),
    "wordlevel-whitespace": (_wordlevel, ["a red bus", "a blue <image> bus!", "x,y"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_port_tokenizer_matches_tokenizers(case, tmp_path):
    """Token for token against the ``tokenizers`` library, with and without
    the special tokens, on each fixture's texts."""
    make, texts = CASES[case]
    tok = make()
    path = str(tmp_path / "tokenizer.json")
    tok.save(path)
    mine = TT.HFTokenizer.from_file(path)
    for add in (True, False):
        for t in texts:
            assert mine.encode(t, add_special_tokens=add) == tok.encode(t, add_special_tokens=add).ids, (t, add)


@pytest.mark.parametrize("sub", ["TinyCogVideoX/tokenizer", "TinyWan/tokenizer", "TinyHunyuanVideo/tokenizer",
                                 "TinyHunyuanVideo/tokenizer_2"])
def test_port_tokenizer_matches_alg_tpu_on_the_tiny_checkpoints(sub, tmp_path):
    """``load_tokenizer`` over each tiny checkpoint's tokenizer directory:
    the same padded ids and masks as ``alg_tpu``'s, at three lengths."""
    name, tok_dir = sub.split("/")
    root = str(tmp_path / name)
    {"TinyCogVideoX": make_tiny_checkpoint.build, "TinyWan": make_tiny_checkpoint.build_wan,
     "TinyHunyuanVideo": make_tiny_checkpoint.build_hunyuan}[name](root)
    prompts = ["a red double decker bus driving down the street", "the panda <image> driving", "x", "",
               "unknown words, punctuation!"]
    port, ref = TT.load_tokenizer(os.path.join(root, tok_dir)), JT.load_tokenizer(os.path.join(root, tok_dir))
    for max_len in (4, 16, 40):
        for a, b in zip(port(prompts, max_len), ref(prompts, max_len)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_precompiled_charsmap_hand_built():
    """A hand-built darts double-array charsmap ('A' -> 'a', 'B' -> 'bb'),
    as ``tests/test_hf_tokenizer.py`` builds it, applied by the port's copy."""
    units = [0] * 16
    units[0] = _darts_unit(offset=0x40)
    units[1] = _darts_unit(label=0x41, has_leaf=True, offset=4)
    units[5] = (1 << 31) | 0
    units[2] = _darts_unit(label=0x42, has_leaf=True, offset=8)
    units[10] = (1 << 31) | 2
    trie_bytes = b"".join(u.to_bytes(4, "little") for u in units)
    blob = len(trie_bytes).to_bytes(4, "little") + trie_bytes + b"a\0bb\0"
    pc = TT.Precompiled(base64.b64encode(blob).decode())
    assert (pc.normalize("A"), pc.normalize("B"), pc.normalize("AB C")) == ("a", "bb", "abb C")
    assert pc.normalize("ünïcode 🙂") == "ünïcode 🙂"


def test_without_regex(tmp_path):
    """With ``regex`` blocked (the card's machine may lack it): the T5-style
    tokenizer gives the ``tokenizers`` ids on ASCII text, and the graphemes
    of the Precompiled normalizer split as ``regex``'s ``\\X`` does there; a
    Llama-3 split pattern (``\\p{L}``) and non-ASCII text raise errors that
    name ``regex``."""
    t5, llama = _t5_style(), _llama3_style()
    t5.save(str(tmp_path / "t5.json"))
    llama.save(str(tmp_path / "llama.json"))
    ascii_texts = [t for t in TEXTS if t.isascii()] + ["crlf\r\nline"]
    want = [t5.encode(t).ids for t in ascii_texts]
    import regex

    graphemes = [regex.findall(r"\X", t) for t in ascii_texts]
    code = (
        "import sys, json\n"
        "sys.modules['regex'] = None\n"
        "from alg_tpu_torch.io import hf_tokenizer as TT\n"
        f"texts = {ascii_texts!r}\n"
        f"tok = TT.HFTokenizer.from_file({str(tmp_path / 't5.json')!r})\n"
        "out = {'ids': [tok.encode(t) for t in texts], 'graphemes': [TT._graphemes(t) for t in texts]}\n"
        "errors = []\n"
        "for thunk in (lambda: TT.HFTokenizer.from_file(%r).encode('hello'), lambda: tok.encode('naïve café')):\n"
        "    try:\n"
        "        thunk()\n"
        "        errors.append(None)\n"
        "    except ImportError as e:\n"
        "        errors.append(str(e))\n"
        "out['errors'] = errors\n"
        "print(json.dumps(out))\n"
    ) % str(tmp_path / "llama.json")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    import json

    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ids"] == want
    assert out["graphemes"] == graphemes
    assert all(e is not None and "regex" in e for e in out["errors"]), out["errors"]
