"""Tokenizers with the interface the engine uses, without the
``tokenizers`` or ``transformers`` packages.

The engine needs only ``__call__`` (returning ``input_ids`` both as a key
and as an attribute), ``encode``, ``decode``, ``pad_token_id`` and
``eos_token_id``; a Hugging Face tokenizer has them, and so do
:class:`WordTokenizer` (a small word-level vocabulary; like a GPT-style one
it tells ``" Yes"`` from ``"Yes"``) and :class:`ByteLevelBPETokenizer`,
which reads a snapshot's byte-level BPE ``tokenizer.json``
(:func:`load_tokenizer`, the reader of the reference loader's
``load_tokenizer``).
"""

from __future__ import annotations

import functools
import heapq
import json
import os
import re
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple, Union


class Encoding(dict):
    """``{"input_ids": ...}`` that also reads as ``.input_ids``."""

    @property
    def input_ids(self):
        return self["input_ids"]


class WordTokenizer:
    """Ids: 0 ``<pad>``, 1 ``</s>`` (EOS), 2 ``<unk>``, then every word of
    ``words`` twice, bare and with a leading space.  Text splits on
    whitespace; the first word of a text is bare, later words carry their
    space.  ``add_special_tokens`` appends nothing (no BOS, as in Falcon's
    tokenizer)."""

    pad_token_id = 0
    eos_token_id = 1
    unk_token_id = 2
    special = ("<pad>", "</s>", "<unk>")

    def __init__(self, words: Sequence[str]):
        self.vocab: List[str] = list(self.special)
        for w in dict.fromkeys(words):
            self.vocab += [w, " " + w]
        self.ids: Dict[str, int] = {t: i for i, t in enumerate(self.vocab)}

    def __len__(self) -> int:
        return len(self.vocab)

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        return [self.ids.get(w if i == 0 and not text[:1].isspace() else " " + w,
                             self.unk_token_id)
                for i, w in enumerate(text.split())]

    def __call__(self, text: Union[str, Sequence[str]],
                 add_special_tokens: bool = True) -> Encoding:
        if isinstance(text, str):
            return Encoding(input_ids=self.encode(text, add_special_tokens))
        return Encoding(input_ids=[self.encode(t, add_special_tokens)
                                   for t in text])

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        out = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i < len(self.special):
                continue
            out.append(self.vocab[i] if 0 <= i < len(self.vocab) else "<unk>")
        return "".join(out)


def default_tokenizer() -> WordTokenizer:
    """A word list with the " Yes"/" No" pair and a few hundred words."""
    words = ["Yes", "No", "Answer:", "Question:", "Is", "a", "the", "of",
             "and", "to", "in", "that", "it", "for", "on", "with", "as",
             "tweet", "publication", "soup", "beverage", "vehicle", "park",
             "contract", "term", "meaning", "ordinary", "reasonable",
             "person", "would", "understand", "word", "include"]
    words += [f"w{i}" for i in range(400)]
    return WordTokenizer(words)


_ITEM_TOK = "ROADMAP.md queue 1, 'Snapshot tokenizers'"

#: Unicode's White_Space property: the ``\\s`` of the split pattern the
#: ``tokenizers`` package compiles (Python's ``\\s`` adds U+001C-U+001F)
_WHITE_SPACE = ("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029"
                "\u202f\u205f\u3000")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({_ITEM_TOK})")


def _class_ranges(pred) -> str:
    """A regex character class body of the code points ``pred`` accepts."""
    out, start, prev = [], None, None
    for cp in range(0x110000):
        if pred(cp):
            if start is None:
                start = cp
            prev = cp
        elif start is not None:
            out.append(re.escape(chr(start)) if start == prev else
                       f"{re.escape(chr(start))}-{re.escape(chr(prev))}")
            start = None
    if start is not None:
        out.append(f"{re.escape(chr(start))}-{re.escape(chr(prev))}")
    return "".join(out)


@functools.lru_cache(maxsize=1)
def _byte_level_split() -> "re.Pattern":
    """The GPT-2 split pattern of the ByteLevel pre-tokenizer,
    ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``,
    spelled for ``re``: ``\\p{L}`` and ``\\p{N}`` become classes of the code
    points whose general category (this Python's ``unicodedata``) starts
    with L or N; built once, on first use (about a second)."""
    cats = [unicodedata.category(chr(cp))[0] for cp in range(0x110000)]
    letters = _class_ranges(lambda cp: cats[cp] == "L")
    numbers = _class_ranges(lambda cp: cats[cp] == "N")
    return re.compile(
        rf"'s|'t|'re|'ve|'m|'ll|'d| ?[{letters}]+| ?[{numbers}]+"
        rf"| ?[^{_WHITE_SPACE}{letters}{numbers}]+"
        rf"|[{_WHITE_SPACE}]+(?![^{_WHITE_SPACE}])|[{_WHITE_SPACE}]+")


@functools.lru_cache(maxsize=1)
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable character table."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _clean_up_tokenization(text: str) -> str:
    """``transformers``' ``clean_up_tokenization``."""
    return (text.replace(" .", ".").replace(" ?", "?").replace(" !", "!")
            .replace(" ,", ",").replace(" ' ", "'").replace(" n't", "n't")
            .replace(" 'm", "'m").replace(" 's", "'s").replace(" 've", "'ve")
            .replace(" 're", "'re"))


class ByteLevelBPETokenizer:
    """A byte-level BPE tokenizer read from a ``tokenizer.json``: the
    ``BPE`` model with its vocabulary and merge ranks, the ``ByteLevel``
    pre-tokenizer, post-processor and decoder, and the added and special
    tokens, and an optional ``NFC`` normalizer (GPT-NeoX-20B's
    ``tokenizer.json`` has one).  Encoding follows the ``tokenizers``
    package: it splits the raw text on the added tokens that are not
    normalized (longest first), normalizes the rest, splits that on the
    normalized added tokens, then pre-tokenizes each other segment with the
    ByteLevel split pattern, maps its UTF-8 bytes to the byte alphabet and
    merges each piece by rank (the lowest-ranked pair first, leftmost among
    equals); decoding maps the tokens back to bytes and decodes them as
    UTF-8 with replacement characters.  Any other model, normalizer,
    pre-tokenizer, post-processor or decoder raises
    ``NotImplementedError``."""

    def __init__(self, spec: Dict, special_tokens: Optional[Dict] = None,
                 clean_up_tokenization_spaces: bool = False):
        model = spec.get("model") or {}
        if model.get("type") != "BPE":
            raise _not_ported(f"tokenizer model {model.get('type')!r}")
        for key in ("dropout", "continuing_subword_prefix",
                    "end_of_word_suffix"):
            if model.get(key):
                raise _not_ported(f"BPE {key}={model[key]!r}")
        if model.get("byte_fallback"):
            raise _not_ported("BPE byte_fallback")
        norm = spec.get("normalizer")
        if norm is not None and norm.get("type") != "NFC":
            raise _not_ported(f"normalizer {norm.get('type')!r}")
        self.nfc = norm is not None
        if spec.get("truncation") is not None:
            raise _not_ported("truncation")
        pre = spec.get("pre_tokenizer") or {}
        if pre.get("type") != "ByteLevel":
            raise _not_ported(f"pre-tokenizer {pre.get('type')!r}")
        for key in ("post_processor", "decoder"):
            part = spec.get(key)
            if part is not None and part.get("type") != "ByteLevel":
                raise _not_ported(f"{key} {part.get('type')!r}")
        self.add_prefix_space = bool(pre.get("add_prefix_space", False))
        self.use_regex = bool(pre.get("use_regex", True))
        self.byte_decoder = spec.get("decoder") is not None
        self.ignore_merges = bool(model.get("ignore_merges", False))
        self.clean_up_tokenization_spaces = bool(clean_up_tokenization_spaces)
        self.vocab: Dict[str, int] = dict(model["vocab"])
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(model.get("merges") or []):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            self.merges[(self.vocab[a], self.vocab[b])] = (rank,
                                                          self.vocab[a + b])
        unk = model.get("unk_token")
        self.unk_id = self.vocab.get(unk) if unk is not None else None
        self.added: Dict[str, int] = {}
        self.special_ids = set()
        normalized = set()      # added tokens matched after normalization
        for tok in spec.get("added_tokens") or []:
            if tok.get("single_word") or tok.get("lstrip") or tok.get("rstrip"):
                raise _not_ported("added tokens with single_word, lstrip or "
                                  "rstrip")
            self.added[tok["content"]] = int(tok["id"])
            if tok.get("special"):
                self.special_ids.add(int(tok["id"]))
            if tok.get("normalized", not tok.get("special", False)):
                normalized.add(tok["content"])
        # special tokens named by the tokenizer config join the added tokens,
        # as transformers adds them when it loads the tokenizer
        self.special_tokens = dict(special_tokens or {})
        names = [v for k, v in self.special_tokens.items()
                 if k != "additional_special_tokens" and v is not None]
        names += list(self.special_tokens.get("additional_special_tokens") or [])
        for content in names:
            if content not in self.added:
                tid = self.vocab.get(content)
                if tid is None:
                    tid = max([*self.vocab.values(), *self.added.values()]) + 1
                self.added[content] = tid
            self.special_ids.add(self.added[content])
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.id_to_token.update({i: t for t, i in self.added.items()})
        self._raw_split = _alternation(t for t in self.added
                                       if t not in normalized)
        self._norm_split = _alternation(self._normalize(t) for t in normalized)
        self._norm_added = {self._normalize(t): self.added[t]
                            for t in normalized}
        self._byte_map = _bytes_to_unicode()
        self._char_bytes = {c: b for b, c in self._byte_map.items()}
        self._cache: Dict[str, List[int]] = {}

    # -- the engine's interface ---------------------------------------------

    def _token_id(self, name: str) -> Optional[int]:
        tok = self.special_tokens.get(name)
        if tok is None:
            return None
        return self.added.get(tok, self.vocab.get(tok))

    @property
    def pad_token_id(self) -> Optional[int]:
        return self._token_id("pad_token")

    @property
    def eos_token_id(self) -> Optional[int]:
        return self._token_id("eos_token")

    @property
    def pad_token(self) -> Optional[str]:
        return self.special_tokens.get("pad_token")

    @property
    def eos_token(self) -> Optional[str]:
        return self.special_tokens.get("eos_token")

    @property
    def unk_token(self) -> Optional[str]:
        return self.special_tokens.get("unk_token")

    def get_vocab(self) -> Dict[str, int]:
        return {**self.vocab, **self.added}

    def __len__(self) -> int:
        return len(self.get_vocab())

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        """Token ids of ``text``; the ByteLevel post-processor adds no
        special tokens, so ``add_special_tokens`` changes nothing."""
        ids: List[int] = []
        for raw, tid in _split_on(self._raw_split, text, self.added):
            if tid is not None:
                ids.append(tid)
                continue
            for piece, nid in _split_on(self._norm_split,
                                        self._normalize(raw), self._norm_added):
                ids += [nid] if nid is not None else self._encode_segment(piece)
        return ids

    def _normalize(self, text: str) -> str:
        return unicodedata.normalize("NFC", text) if self.nfc else text

    def __call__(self, text: Union[str, Sequence[str]],
                 add_special_tokens: bool = True) -> Encoding:
        if isinstance(text, str):
            return Encoding(input_ids=self.encode(text, add_special_tokens))
        return Encoding(input_ids=[self.encode(t, add_special_tokens)
                                   for t in text])

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        tokens = []
        for i in ids:
            i = int(i)
            tok = self.id_to_token.get(i)
            if tok is None or (skip_special_tokens and i in self.special_ids):
                continue
            tokens.append(tok)
        if self.byte_decoder:
            raw = bytearray()
            for tok in tokens:
                try:
                    raw += bytes(self._char_bytes[c] for c in tok)
                except KeyError:      # a token outside the byte alphabet
                    raw += tok.encode("utf-8")
            text = raw.decode("utf-8", errors="replace")
        else:
            text = " ".join(tokens)
        if self.clean_up_tokenization_spaces:
            text = _clean_up_tokenization(text)
        return text

    # -- encoding ------------------------------------------------------------

    def _encode_segment(self, text: str) -> List[int]:
        if not text:
            return []
        if self.add_prefix_space and not text.startswith(" "):
            text = " " + text
        if self.use_regex:
            pieces, pos = [], 0
            for m in _byte_level_split().finditer(text):
                if m.start() > pos:           # an unmatched gap is a piece too
                    pieces.append(text[pos:m.start()])
                pieces.append(m.group(0))
                pos = m.end()
            if pos < len(text):
                pieces.append(text[pos:])
        else:
            pieces = [text]
        ids: List[int] = []
        for piece in pieces:
            word = "".join(self._byte_map[b] for b in piece.encode("utf-8"))
            cached = self._cache.get(word)
            if cached is None:
                cached = self._cache[word] = self._bpe(word)
            ids += cached
        return ids

    def _bpe(self, word: str) -> List[int]:
        """Merge one pre-tokenized piece by rank: a heap of (rank,
        position) pairs, each popped pair merged if both symbols are still
        there, then its new neighbours pushed."""
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        syms: List[int] = []
        for c in word:
            tid = self.vocab.get(c)
            if tid is not None:
                syms.append(tid)
            elif self.unk_id is not None:
                syms.append(self.unk_id)
        n = len(syms)
        nxt = list(range(1, n + 1))
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = self.merges.get((syms[i], syms[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            rank, i, new_id = heapq.heappop(heap)
            if not alive[i] or nxt[i] >= n:
                continue
            j = nxt[i]
            m = self.merges.get((syms[i], syms[j]))
            if m is None or m[1] != new_id:
                continue
            syms[i] = new_id
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] < n:
                prv[nxt[j]] = i
            if prv[i] >= 0:
                m = self.merges.get((syms[prv[i]], syms[i]))
                if m is not None:
                    heapq.heappush(heap, (m[0], prv[i], m[1]))
            if nxt[i] < n:
                m = self.merges.get((syms[i], syms[nxt[i]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], i, m[1]))
        return [t for t, a in zip(syms, alive) if a]


def _alternation(tokens) -> Optional["re.Pattern"]:
    """A pattern matching any of ``tokens``, the longest first; None for
    none."""
    tokens = sorted(set(tokens), key=len, reverse=True)
    return re.compile("|".join(map(re.escape, tokens))) if tokens else None


def _split_on(pattern, text: str, ids: Dict[str, int]):
    """``text`` as ``(segment, None)`` and ``(token, id)`` pieces, split
    where ``pattern`` matches one of the tokens ``ids`` names; empty
    segments are left out."""
    pos = 0
    for m in (pattern.finditer(text) if pattern is not None else ()):
        if m.start() > pos:
            yield text[pos:m.start()], None
        yield m.group(0), ids[m.group(0)]
        pos = m.end()
    if pos < len(text):
        yield text[pos:], None


def _special_token(value) -> Optional[str]:
    return value.get("content") if isinstance(value, dict) else value


def load_tokenizer(path: str) -> ByteLevelBPETokenizer:
    """The snapshot's ``tokenizer.json`` as a :class:`ByteLevelBPETokenizer`,
    its special tokens from ``tokenizer_config.json`` overridden by
    ``special_tokens_map.json`` (as transformers reads them), and the
    reference loader's pad rule: without a pad token, the EOS token pads,
    else ``<|endoftext|>``, else the unknown token, else the token with the
    smallest id (pad positions are masked, so any id in range works)."""
    with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
        spec = json.load(f)
    special: Dict = {}
    clean_up = False
    for name in ("tokenizer_config.json", "special_tokens_map.json"):
        fname = os.path.join(path, name)
        if not os.path.exists(fname):
            continue
        with open(fname, encoding="utf-8") as f:
            conf = json.load(f)
        if name == "tokenizer_config.json":
            clean_up = bool(conf.get("clean_up_tokenization_spaces", False))
        for key in ("bos_token", "eos_token", "unk_token", "pad_token"):
            if conf.get(key) is not None:
                special[key] = _special_token(conf[key])
        if conf.get("additional_special_tokens"):
            special["additional_special_tokens"] = [
                _special_token(t) for t in conf["additional_special_tokens"]]
    tok = ByteLevelBPETokenizer(spec, special, clean_up)
    if tok.pad_token_id is None:
        vocab = tok.get_vocab()
        if tok.eos_token is not None:
            pad = tok.eos_token
        elif "<|endoftext|>" in vocab:
            pad = "<|endoftext|>"
        elif tok.unk_token is not None:
            pad = tok.unk_token
        else:
            pad = min(vocab, key=vocab.get)
        tok.special_tokens["pad_token"] = pad
    return tok
