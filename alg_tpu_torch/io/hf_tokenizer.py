r"""Pure-Python ``tokenizer.json`` interpreter — transformers-free tokenization
(the port's copy of ``alg_tpu/io/hf_tokenizer.py``).

The four text encoders in scope (T5-XXL — CogVideoX, UMT5-XXL — Wan,
Llama-3 — Hunyuan/Llava, CLIP — Hunyuan) all ship HF *fast* tokenizer files
(``tokenizer.json``). This module interprets that format directly, so
tokenization needs neither ``transformers`` nor the Rust ``tokenizers``
wheel at runtime (mirroring ``core/torch_rng.py``'s torch-free RNG: the
heavyweight stacks stay test-only parity oracles).

Supported components (the union of what those four tokenizers use):

* normalizers: Sequence, Precompiled (the SentencePiece charsmap — parsed
  from its darts double-array trie, grapheme-wise application like the
  ``spm_precompiled`` crate), Replace, Lowercase, NFC/NFD/NFKC/NFKD, Strip,
  Prepend, BertNormalizer (clean_text/lowercase subset)
* pre-tokenizers: Sequence, Metaspace (all prepend schemes), ByteLevel
  (incl. the GPT-2 default regex), Split (Regex/String patterns; Isolated /
  Removed / MergedWithPrevious / MergedWithNext / Contiguous), Whitespace,
  WhitespaceSplit, Punctuation, Digits
* models: Unigram (Viterbi lattice, byte_fallback, fuse_unk), BPE
  (merge ranks, ``ignore_merges`` — Llama-3, ``end_of_word_suffix`` — CLIP,
  ``continuing_subword_prefix``, byte_fallback), WordLevel, WordPiece
* post-processors: TemplateProcessing, ByteLevel, RobertaProcessing,
  BertProcessing, Sequence
* added/special tokens (AddedVocabulary): longest-match split before
  normalization (``normalized: false``) or after (``normalized: true``),
  ``lstrip``/``rstrip``/``single_word`` — the Llava ``<image>`` token rides
  this path

Parity: validated token-for-token against the Rust ``tokenizers`` library
over structurally-faithful fixtures of all four tokenizer families
(``tests/test_torch_port_io_tokenizer.py``, on the cases of
``tests/test_hf_tokenizer.py``) and against ``alg_tpu``'s copy.

``regex`` is imported on first use and is optional: the HF split patterns
of Llama-3, CLIP and GPT-2 (``\p{L}``, ``\p{N}``) and the grapheme
clusters of the Precompiled normalizer (``\X``) need it. Without it Python's
``re`` serves the patterns it compiles to the same meaning, and only
ASCII text is encoded (where the two modules agree, and a grapheme is a
character or CR LF): a pattern ``re`` cannot compile, or other text, raises
an error that names ``regex``, never a silently different split. T5's and
UMT5's Unigram + Metaspace path compiles no such pattern.
"""

from __future__ import annotations

import base64
import json
import os
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

_RE_MODULE = []  # [regex or re], filled on first use


def _re_module():
    r"""``regex`` where it is installed (``\p{..}`` classes, ``\X``
    graphemes), else Python's ``re``."""
    if not _RE_MODULE:
        try:
            import regex as mod
        except ImportError:
            import re as mod
        _RE_MODULE.append(mod)
    return _RE_MODULE[0]


def _has_regex() -> bool:
    return _re_module().__name__ == "regex"


class _LazyRe:
    def __getattr__(self, name):
        return getattr(_re_module(), name)


_re = _LazyRe()

_NEEDS_REGEX = "install the `regex` package (Python's `re` lacks HF tokenizers' \\p{..} classes and \\X)"


def _compile(pattern: str):
    """``pattern`` compiled; a pattern that only ``regex`` compiles raises
    an error that names it when ``re`` stands in."""
    try:
        return _re.compile(pattern)
    except _re.error as err:
        if _has_regex():
            raise
        raise ImportError(f"tokenizer pattern {pattern!r}: {err}; {_NEEDS_REGEX}") from err


def _require_plain_text(text: str) -> None:
    r"""Without ``regex`` only ASCII text is encoded: printable characters
    and the whitespace ``\t \n \v \f \r``, on which ``re`` and ``regex``
    agree and a grapheme cluster is one character or CR LF."""
    if _has_regex():
        return
    for ch in text:
        if not (" " <= ch <= "~" or ch in "\t\n\v\f\r"):
            raise ImportError(f"cannot tokenize {text[:40]!r} (character {ch!r}) without `regex`: {_NEEDS_REGEX}")


def _graphemes(text: str) -> List[str]:
    if _has_regex():
        return _re.findall(r"\X", text)
    _require_plain_text(text)
    return _re.findall(r"\r\n|[\s\S]", text)


# ---------------------------------------------------------------------------
# SentencePiece precompiled charsmap (normalizers.Precompiled)
# ---------------------------------------------------------------------------


class _DoubleArrayTrie:
    """darts-clone double array as serialized in precompiled_charsmap."""

    def __init__(self, units):
        self.units = units

    @staticmethod
    def _has_leaf(unit: int) -> bool:
        return bool((unit >> 8) & 1)

    @staticmethod
    def _value(unit: int) -> int:
        return unit & 0x7FFFFFFF

    @staticmethod
    def _label(unit: int) -> int:
        return unit & ((1 << 31) | 0xFF)

    @staticmethod
    def _offset(unit: int) -> int:
        return (unit >> 10) << ((unit & (1 << 9)) >> 6)

    def common_prefix_search(self, key: bytes) -> List[int]:
        results: List[int] = []
        units = self.units
        if not len(units):
            return results
        node_pos = 0
        unit = units[node_pos]
        node_pos ^= self._offset(unit)
        for c in key:
            if c == 0:
                break
            node_pos ^= c
            if node_pos >= len(units):
                return results
            unit = units[node_pos]
            if self._label(unit) != c:
                return results
            node_pos ^= self._offset(unit)
            if self._has_leaf(unit):
                results.append(self._value(units[node_pos]))
        return results


class Precompiled:
    def __init__(self, charsmap_b64: str):
        import numpy as np

        blob = base64.b64decode(charsmap_b64)
        trie_size = int.from_bytes(blob[:4], "little")
        trie = np.frombuffer(blob[4 : 4 + trie_size], dtype="<u4")
        self.trie = _DoubleArrayTrie(trie)
        self.normalized = blob[4 + trie_size :]

    def _transform(self, chunk: str) -> Optional[str]:
        results = self.trie.common_prefix_search(chunk.encode("utf-8"))
        if not results:
            return None
        index = results[0]
        end = self.normalized.find(b"\0", index)
        if end == -1:
            end = len(self.normalized)
        return self.normalized[index:end].decode("utf-8")

    def normalize(self, text: str) -> str:
        out: List[str] = []
        for grapheme in _graphemes(text):
            if len(grapheme.encode("utf-8")) < 6:
                norm = self._transform(grapheme)
                if norm is not None:
                    out.append(norm)
                    continue
            for ch in grapheme:
                norm = self._transform(ch)
                out.append(ch if norm is None else norm)
        return "".join(out)


# ---------------------------------------------------------------------------
# normalizers
# ---------------------------------------------------------------------------


def _compile_pattern(pattern: dict):
    if "Regex" in pattern:
        return _compile(pattern["Regex"])
    return _re.compile(_re.escape(pattern["String"]))


def _make_normalizer(spec: Optional[dict]):
    if spec is None:
        return lambda s: s
    t = spec["type"]
    if t == "Sequence":
        fns = [_make_normalizer(s) for s in spec["normalizers"]]

        def seq(s):
            for f in fns:
                s = f(s)
            return s

        return seq
    if t == "Precompiled":
        return Precompiled(spec["precompiled_charsmap"]).normalize
    if t == "Replace":
        pat = _compile_pattern(spec["pattern"])
        return lambda s: pat.sub(spec["content"], s)
    if t == "Lowercase":
        return lambda s: s.lower()
    if t in ("NFC", "NFD", "NFKC", "NFKD"):
        return lambda s: unicodedata.normalize(t, s)
    if t == "Strip":
        left, right = spec.get("strip_left", True), spec.get("strip_right", True)

        def strip(s):
            if left:
                s = s.lstrip()
            if right:
                s = s.rstrip()
            return s

        return strip
    if t == "Prepend":
        prepend = spec["prepend"]
        return lambda s: (prepend + s) if s else s
    if t == "BertNormalizer":
        lowercase = spec.get("lowercase", True)
        clean = spec.get("clean_text", True)

        def bert(s):
            if clean:
                s = "".join(
                    " " if ch in "\t\n\r" else ch
                    for ch in s
                    if ch != "\0" and unicodedata.category(ch) != "Cf"
                )
            if lowercase:
                s = s.lower()
            return s

        return bert
    raise NotImplementedError(f"normalizer {t}")


# ---------------------------------------------------------------------------
# pre-tokenizers  (str → list[str] pieces)
# ---------------------------------------------------------------------------

_GPT2_SPLIT = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""

# GPT-2 byte → printable-unicode table (ByteLevel alphabet)
_BYTE_ENCODER: Dict[int, str] = {}


def _byte_encoder() -> Dict[int, str]:
    if not _BYTE_ENCODER:
        bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
        cs = bs[:]
        n = 0
        for b in range(256):
            if b not in bs:
                bs.append(b)
                cs.append(256 + n)
                n += 1
        _BYTE_ENCODER.update({b: chr(c) for b, c in zip(bs, cs)})
    return _BYTE_ENCODER


def _split_pieces(text: str, pat, behavior: str, invert: bool = False) -> List[str]:
    """tokenizers SplitDelimiterBehavior over regex matches (the matches are
    the delimiters unless ``invert``)."""
    if invert:
        return [m.group(0) for m in pat.finditer(text)]
    pieces: List[str] = []
    last = 0
    for m in pat.finditer(text):
        a, b = m.span()
        if a == b:
            continue
        before = text[last:a]
        if behavior == "Removed":
            if before:
                pieces.append(before)
        elif behavior == "Isolated":
            if before:
                pieces.append(before)
            pieces.append(text[a:b])
        elif behavior == "MergedWithPrevious":
            pieces.append(before + text[a:b])
        elif behavior == "MergedWithNext":
            if before:
                pieces.append(before)
            last = a
            continue
        elif behavior == "Contiguous":
            if before:
                pieces.append(before)
            pieces.append(text[a:b])
        else:  # pragma: no cover
            raise NotImplementedError(f"split behavior {behavior}")
        last = b
    tail = text[last:]
    if tail:
        if behavior == "MergedWithNext" and pieces is not None:
            pieces.append(tail)
        else:
            pieces.append(tail)
    return pieces


def _make_pre_tokenizer(spec: Optional[dict]):
    if spec is None:
        return lambda s: [s] if s else []
    t = spec["type"]
    if t == "Sequence":
        fns = [_make_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def seq(s):
            pieces = [s]
            for f in fns:
                pieces = [p2 for p in pieces for p2 in f(p)]
            return pieces

        return seq
    if t == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        split = spec.get("split", True)

        def metaspace(s, _first=[True]):
            if not s:
                return []
            out = s.replace(" ", rep)
            if scheme == "always" or (scheme == "first" and metaspace._first):
                if not out.startswith(rep):
                    out = rep + out
            metaspace._first = False
            if not split:
                return [out] if out else []
            pieces = _re.findall(_re.escape(rep) + r"[^" + _re.escape(rep) + r"]*|[^" + _re.escape(rep) + r"]+", out)
            return pieces

        metaspace._first = True

        def wrapper(s):
            return metaspace(s)

        wrapper._reset = lambda: setattr(metaspace, "_first", True)
        return wrapper
    if t == "ByteLevel":
        add_prefix = spec.get("add_prefix_space", True)
        use_regex = spec.get("use_regex", True)
        gpt2 = _compile(_GPT2_SPLIT) if use_regex else None
        enc = _byte_encoder()

        def bytelevel(s):
            if add_prefix and s and not s.startswith(" "):
                s = " " + s
            words = [m.group(0) for m in gpt2.finditer(s)] if use_regex else [s]
            return [
                "".join(enc[b] for b in w.encode("utf-8")) for w in words if w
            ]

        return bytelevel
    if t == "Split":
        pat = _compile_pattern(spec["pattern"])
        behavior = spec.get("behavior", "Removed")
        invert = spec.get("invert", False)
        return lambda s: _split_pieces(s, pat, behavior, invert)
    if t == "Whitespace":
        pat = _compile(r"\w+|[^\w\s]+")
        return lambda s: pat.findall(s)
    if t == "WhitespaceSplit":
        return lambda s: s.split()
    if t == "Punctuation":
        behavior = spec.get("behavior", "Isolated")
        pat = _compile(r"\p{P}")
        return lambda s: _split_pieces(s, pat, behavior)
    if t == "Digits":
        individual = spec.get("individual_digits", False)
        pat = _compile(r"\p{N}" if individual else r"\p{N}+")
        return lambda s: _split_pieces(s, pat, "Isolated")
    raise NotImplementedError(f"pre_tokenizer {t}")


# ---------------------------------------------------------------------------
# models  (word piece → ids)
# ---------------------------------------------------------------------------


class _Unigram:
    def __init__(self, spec: dict):
        self.vocab: List[Tuple[str, float]] = [tuple(v) for v in spec["vocab"]]
        self.scores = {tok: score for tok, score in self.vocab}
        self.ids = {tok: i for i, (tok, _) in enumerate(self.vocab)}
        self.unk_id = spec.get("unk_id")
        self.byte_fallback = spec.get("byte_fallback", False)
        self.max_len = max((len(t) for t, _ in self.vocab), default=1)
        self.fuse_unk = True  # tokenizers defaults Unigram fuse_unk=true when unk set

    def tokenize(self, word: str) -> List[int]:
        n = len(word)
        if n == 0:
            return []
        NEG = -1e10
        # Viterbi over characters
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, Optional[str]]]] = [None] * (n + 1)
        best[0] = 0.0
        unk_penalty = 10.0  # spm kUnkPenalty
        min_score = min((s for _, s in self.vocab), default=0.0)
        unk_score = min_score - unk_penalty
        for i in range(n):
            if best[i] <= NEG / 2:
                continue
            for j in range(i + 1, min(n, i + self.max_len) + 1):
                piece = word[i:j]
                score = self.scores.get(piece)
                if score is not None and best[i] + score > best[j]:
                    best[j] = best[i] + score
                    back[j] = (i, piece)
            # unk: single char
            j = i + 1
            if self.scores.get(word[i:j]) is None:
                if best[i] + unk_score > best[j]:
                    best[j] = best[i] + unk_score
                    back[j] = (i, None)
        pieces: List[Optional[str]] = []
        pos = n
        while pos > 0:
            prev, piece = back[pos]
            pieces.append(piece if piece is not None else word[prev:pos])
            if piece is None:
                pieces[-1] = None if not self.byte_fallback else word[prev:pos]
                if self.byte_fallback:
                    pieces[-1] = ("__byte__", word[prev:pos])
            pos = prev
        pieces.reverse()
        ids: List[int] = []
        unk_run = False
        for p in pieces:
            if isinstance(p, tuple):  # byte fallback
                for b in p[1].encode("utf-8"):
                    tok = f"<0x{b:02X}>"
                    if tok in self.ids:
                        ids.append(self.ids[tok])
                    elif self.unk_id is not None:
                        ids.append(self.unk_id)
                unk_run = False
            elif p is None or p not in self.ids:
                if self.unk_id is None:
                    continue
                if self.fuse_unk and unk_run:
                    continue
                ids.append(self.unk_id)
                unk_run = True
            else:
                ids.append(self.ids[p])
                unk_run = False
        return ids


class _BPE:
    def __init__(self, spec: dict):
        self.vocab: Dict[str, int] = spec["vocab"]
        merges = spec.get("merges", [])
        self.ranks: Dict[Tuple[str, str], int] = {}
        for i, m in enumerate(merges):
            pair = tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
            self.ranks[pair] = i
        self.unk = spec.get("unk_token")
        self.cont_prefix = spec.get("continuing_subword_prefix") or ""
        self.eow_suffix = spec.get("end_of_word_suffix") or ""
        self.ignore_merges = spec.get("ignore_merges", False)
        self.byte_fallback = spec.get("byte_fallback", False)
        self.fuse_unk = spec.get("fuse_unk", False)

    def tokenize(self, word: str) -> List[int]:
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        chars = list(word)
        if not chars:
            return []
        parts = []
        for i, c in enumerate(chars):
            piece = c if i == 0 else self.cont_prefix + c
            if i == len(chars) - 1:
                piece = piece + self.eow_suffix
            parts.append(piece)
        while len(parts) > 1:
            best_rank, best_i = None, None
            for i in range(len(parts) - 1):
                r = self.ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        ids: List[int] = []
        unk_run = False
        for p in parts:
            if p in self.vocab:
                ids.append(self.vocab[p])
                unk_run = False
            elif self.byte_fallback:
                for b in p.encode("utf-8"):
                    tok = f"<0x{b:02X}>"
                    if tok in self.vocab:
                        ids.append(self.vocab[tok])
                unk_run = False
            elif self.unk is not None:
                if not (self.fuse_unk and unk_run):
                    ids.append(self.vocab[self.unk])
                unk_run = True
        return ids


class _WordLevel:
    def __init__(self, spec: dict):
        self.vocab = spec["vocab"]
        self.unk = spec.get("unk_token")

    def tokenize(self, word: str) -> List[int]:
        if word in self.vocab:
            return [self.vocab[word]]
        if self.unk is not None and self.unk in self.vocab:
            return [self.vocab[self.unk]]
        return []


class _WordPiece:
    def __init__(self, spec: dict):
        self.vocab = spec["vocab"]
        self.unk = spec.get("unk_token", "[UNK]")
        self.prefix = spec.get("continuing_subword_prefix", "##")
        self.max_chars = spec.get("max_input_chars_per_word", 100)

    def tokenize(self, word: str) -> List[int]:
        if len(word) > self.max_chars:
            return [self.vocab[self.unk]]
        out, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = self.prefix + piece
                if piece in self.vocab:
                    cur = piece
                    break
                end -= 1
            if cur is None:
                return [self.vocab[self.unk]]
            out.append(self.vocab[cur])
            start = end
        return out


def _make_model(spec: dict):
    t = spec["type"]
    if t == "Unigram":
        return _Unigram(spec)
    if t == "BPE":
        return _BPE(spec)
    if t == "WordLevel":
        return _WordLevel(spec)
    if t == "WordPiece":
        return _WordPiece(spec)
    raise NotImplementedError(f"model {t}")


# ---------------------------------------------------------------------------
# post-processors
# ---------------------------------------------------------------------------


def _make_post_processor(spec: Optional[dict], token_to_id):
    """Returns ``(ids, add_special) → ids`` for single sequences."""
    if spec is None:
        return lambda ids, add: ids
    t = spec["type"]
    if t == "Sequence":
        fns = [_make_post_processor(s, token_to_id) for s in spec["processors"]]

        def seq(ids, add):
            for f in fns:
                ids = f(ids, add)
            return ids

        return seq
    if t == "ByteLevel":
        return lambda ids, add: ids
    if t == "TemplateProcessing":
        single = spec["single"]
        special = {
            name: tokens["ids"][i]
            for name, tokens in (
                (st["id"], st) for st in spec.get("special_tokens", {}).values()
            )
            for i in range(len(tokens["ids"]))
            if tokens["tokens"][i] == name
        } if isinstance(spec.get("special_tokens"), dict) else {}
        if not special and isinstance(spec.get("special_tokens"), dict):
            special = {k: v["ids"][0] for k, v in spec["special_tokens"].items()}

        def template(ids, add):
            out: List[int] = []
            for piece in single:
                if "Sequence" in piece:
                    if piece["Sequence"]["id"] == "A":
                        out.extend(ids)
                elif "SpecialToken" in piece:
                    if add:
                        name = piece["SpecialToken"]["id"]
                        if name in special:
                            out.append(special[name])
                        else:
                            tid = token_to_id(name)
                            if tid is None:
                                raise KeyError(f"special token {name!r} unknown")
                            out.append(tid)
            return out

        return template
    if t in ("RobertaProcessing", "BertProcessing"):
        sep = spec["sep"]
        cls = spec["cls"]

        def roberta(ids, add):
            if not add:
                return ids
            return [cls[1]] + ids + [sep[1]]

        return roberta
    raise NotImplementedError(f"post_processor {t}")


# ---------------------------------------------------------------------------
# added tokens + top-level tokenizer
# ---------------------------------------------------------------------------


class HFTokenizer:
    """Encode-only interpreter for HF ``tokenizer.json``."""

    def __init__(self, data: dict):
        self.data = data
        self.normalizer = _make_normalizer(data.get("normalizer"))
        self.pre_tokenizer_spec = data.get("pre_tokenizer")
        self.model = _make_model(data["model"])
        vocab = data["model"].get("vocab")
        if isinstance(vocab, dict):
            self._token_ids = dict(vocab)
        else:  # Unigram list
            self._token_ids = {tok: i for i, (tok, _) in enumerate(vocab)}
        self.added = sorted(
            (t for t in data.get("added_tokens", [])),
            key=lambda t: -len(t["content"]),
        )
        for t in self.added:
            self._token_ids.setdefault(t["content"], t["id"])
        self.post = _make_post_processor(data.get("post_processor"), self.token_to_id)

    @classmethod
    def from_file(cls, path: str) -> "HFTokenizer":
        with open(path, encoding="utf-8") as fh:
            return cls(json.load(fh))

    def token_to_id(self, token: str) -> Optional[int]:
        return self._token_ids.get(token)

    # -- added-token splitting (AddedVocabulary) ---------------------------

    def _split_added(self, text: str, normalized_pass: bool):
        """[(segment, added_id|None)] for tokens of the given normalization
        class; longest content matches first."""
        toks = [
            t for t in self.added
            if bool(t.get("normalized", False)) == normalized_pass and t["content"]
        ]
        if not toks:
            return [(text, None)]
        pattern = "|".join(_re.escape(t["content"]) for t in toks)
        by_content = {t["content"]: t for t in toks}
        segments: List[Tuple[str, Optional[int]]] = []
        last = 0
        for m in _re.finditer(pattern, text):
            t = by_content[m.group(0)]
            a, b = m.span()
            if t.get("single_word"):
                before = text[a - 1] if a > 0 else " "
                after = text[b] if b < len(text) else " "
                if _re.match(r"\w", before) or _re.match(r"\w", after):
                    continue
            if t.get("lstrip"):
                while a > 0 and text[a - 1].isspace():
                    a -= 1
            if t.get("rstrip"):
                while b < len(text) and text[b].isspace():
                    b += 1
            if text[last:a]:
                segments.append((text[last:a], None))
            segments.append((m.group(0), t["id"]))
            last = b
        if text[last:]:
            segments.append((text[last:], None))
        return segments

    # -- encode ------------------------------------------------------------

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        _require_plain_text(text)
        ids: List[int] = []
        pre = _make_pre_tokenizer(self.pre_tokenizer_spec)  # fresh (Metaspace "first")
        for seg, added_id in self._split_added(text, normalized_pass=False):
            if added_id is not None:
                ids.append(added_id)
                continue
            norm = self.normalizer(seg)
            for seg2, added_id2 in self._split_added(norm, normalized_pass=True):
                if added_id2 is not None:
                    ids.append(added_id2)
                    continue
                for word in pre(seg2):
                    ids.extend(self.model.tokenize(word))
        return self.post(ids, add_special_tokens)


def load_tokenizer(tok_dir: str):
    """``(prompts, max_length) → int ids [B, max_length]`` from a tokenizer
    directory, transformers-free when ``tokenizer.json`` exists (else None).

    Padding/truncation follow the HF slow-call semantics the model_zoo
    closures used: truncate to ``max_length`` (specials preserved by
    truncating the sequence body first is NOT replicated — the reference
    pipelines truncate the tail exactly like this), pad with the configured
    pad token to ``max_length``.
    """
    path = os.path.join(tok_dir, "tokenizer.json")
    if not os.path.exists(path):
        return None
    tok = HFTokenizer.from_file(path)

    pad_id = 0
    cfg_path = os.path.join(tok_dir, "tokenizer_config.json")
    pad_token = None
    if os.path.exists(cfg_path):
        with open(cfg_path, encoding="utf-8") as fh:
            cfg = json.load(fh)
        pad_token = cfg.get("pad_token")
        if isinstance(pad_token, dict):
            pad_token = pad_token.get("content")
    if pad_token is None:
        pad_spec = tok.data.get("padding") or {}
        pad_token = pad_spec.get("pad_token")
    if pad_token is not None:
        pid = tok.token_to_id(pad_token)
        if pid is not None:
            pad_id = pid

    # specials the post-processor adds around a single sequence — HF
    # truncation keeps them and trims the BODY to fit (T5's </s> survives)
    overhead = len(tok.post([], True))

    def tokenize(prompts: Sequence[str], max_length: int):
        import numpy as np

        rows, masks = [], []
        for p in prompts:
            body = tok.encode(p, add_special_tokens=False)
            ids = tok.post(body[: max(0, max_length - overhead)], True)[:max_length]
            mask = [1] * len(ids) + [0] * (max_length - len(ids))
            rows.append(ids + [pad_id] * (max_length - len(ids)))
            masks.append(mask)
        return np.asarray(rows, np.int64), np.asarray(masks, np.int64)

    return tokenize
