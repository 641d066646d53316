"""Tokenizers with the interface the engine uses, without the
``tokenizers`` or ``transformers`` packages.

The engine needs only ``__call__`` (returning ``input_ids`` both as a key
and as an attribute), ``encode``, ``decode``, ``pad_token_id`` and
``eos_token_id``; a Hugging Face tokenizer has them, and so do
:class:`WordTokenizer` (a small word-level vocabulary; like a GPT-style one
it tells ``" Yes"`` from ``"Yes"``) and the readers of a snapshot's
tokenizer files (:func:`load_tokenizer`, the reader of the reference
loader's ``load_tokenizer``): :class:`ByteLevelBPETokenizer` (a byte-level
BPE ``tokenizer.json``, or ``vocab.json`` and ``merges.txt``),
:class:`UnigramTokenizer` (T5's Unigram ``tokenizer.json``) and
:class:`QwenTokenizer` (Qwen-1's ``qwen.tiktoken``).
"""

from __future__ import annotations

import base64
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


class _SnapshotTokenizer:
    """What the readers of a snapshot's tokenizer files share: the added
    and special tokens, the pad / EOS / unknown tokens the tokenizer config
    names, the engine's interface, and the ``tokenizers`` package's order
    of encoding: split the raw text on the added tokens that are not
    normalized (longest first), normalize the rest, split that on the
    normalized added tokens, and encode each other segment with the model
    (:meth:`_encode_segment`).  A subclass sets ``self.vocab`` (token ->
    id) and ``self._normalize`` before calling ``__init__``."""

    vocab: Dict[str, int]

    def __init__(self, spec: Dict, special_tokens: Optional[Dict] = None,
                 clean_up_tokenization_spaces: bool = False):
        if spec.get("truncation") is not None:
            raise _not_ported("truncation")
        self.clean_up_tokenization_spaces = bool(clean_up_tokenization_spaces)
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
        """Token ids of ``text``, with the post-processor's special tokens
        when ``add_special_tokens``."""
        ids: List[int] = []
        for raw, tid in _split_on(self._raw_split, text, self.added):
            if tid is not None:
                ids.append(tid)
                continue
            for piece, nid in _split_on(self._norm_split, self._normalize(raw),
                                        self._norm_added):
                ids += [nid] if nid is not None else self._encode_segment(piece)
        return self._post_process(ids) if add_special_tokens else ids

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
        text = self._decode_tokens(tokens)
        if self.clean_up_tokenization_spaces:
            text = _clean_up_tokenization(text)
        return text

    def _post_process(self, ids: List[int]) -> List[int]:
        return ids

    def _encode_segment(self, text: str) -> List[int]:
        raise NotImplementedError

    def _decode_tokens(self, tokens: List[str]) -> str:
        raise NotImplementedError


class ByteLevelBPETokenizer(_SnapshotTokenizer):
    """A byte-level BPE tokenizer read from a ``tokenizer.json`` (or built
    from a ``vocab.json`` and ``merges.txt``, :func:`load_tokenizer`): the
    ``BPE`` model with its vocabulary and merge ranks, the ``ByteLevel``
    pre-tokenizer, post-processor and decoder, and the added and special
    tokens, and an optional ``NFC`` normalizer (GPT-NeoX-20B's
    ``tokenizer.json`` has one).  Each segment between added tokens is
    pre-tokenized with the ByteLevel split pattern, its UTF-8 bytes mapped
    to the byte alphabet, and each piece merged by rank (the lowest-ranked
    pair first, leftmost among equals); decoding maps the tokens back to
    bytes and decodes them as UTF-8 with replacement characters.  With
    ``add_bos_token`` (a GPT-2-style tokenizer config's flag, as OPT's
    sets it) an encoding with special tokens starts with the BOS token.
    Any other model, normalizer, pre-tokenizer, post-processor or decoder
    raises ``NotImplementedError``."""

    def __init__(self, spec: Dict, special_tokens: Optional[Dict] = None,
                 clean_up_tokenization_spaces: bool = False,
                 add_bos_token: bool = False):
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
        self.add_bos_token = bool(add_bos_token)
        self.vocab = dict(model["vocab"])
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(model.get("merges") or []):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            self.merges[(self.vocab[a], self.vocab[b])] = (rank,
                                                          self.vocab[a + b])
        unk = model.get("unk_token")
        self.unk_id = self.vocab.get(unk) if unk is not None else None
        self._byte_map = _bytes_to_unicode()
        self._char_bytes = {c: b for b, c in self._byte_map.items()}
        self._cache: Dict[str, List[int]] = {}
        super().__init__(spec, special_tokens, clean_up_tokenization_spaces)

    def _normalize(self, text: str) -> str:
        return unicodedata.normalize("NFC", text) if self.nfc else text

    def _post_process(self, ids: List[int]) -> List[int]:
        bos = self._token_id("bos_token")
        if self.add_bos_token and bos is not None:
            return [bos] + ids
        return ids

    def _decode_tokens(self, tokens: List[str]) -> str:
        if not self.byte_decoder:
            return " ".join(tokens)
        raw = bytearray()
        for tok in tokens:
            try:
                raw += bytes(self._char_bytes[c] for c in tok)
            except KeyError:      # a token outside the byte alphabet
                raw += tok.encode("utf-8")
        return raw.decode("utf-8", errors="replace")

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


#: :data:`_WHITE_SPACE` as characters, for ``str.strip``
_WHITE_SPACE_CHARS = "".join(c for c in map(chr, range(0x3001))
                             if re.fullmatch(f"[{_WHITE_SPACE}]", c))


def _normalizer(spec: Optional[Dict]):
    """A ``tokenizer.json`` normalizer as a function on text: ``Sequence``,
    ``Replace`` (a string or a regex pattern), ``Strip``, ``NFC``,
    ``NFKC``, ``Lowercase``, and ``Precompiled`` with an empty charsmap;
    anything else raises ``NotImplementedError``."""
    if spec is None:
        return lambda text: text
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [_normalizer(s) for s in spec.get("normalizers") or []]

        def seq(text):
            for part in parts:
                text = part(text)
            return text
        return seq
    if kind == "Replace":
        pattern, content = spec["pattern"], spec["content"]
        if "Regex" in pattern:
            regex = re.compile(pattern["Regex"])
            return lambda text: regex.sub(lambda _: content, text)
        return lambda text: text.replace(pattern["String"], content)
    if kind == "Strip":
        left, right = spec.get("strip_left", True), spec.get("strip_right", True)

        def strip(text):
            if left:
                text = text.lstrip(_WHITE_SPACE_CHARS)
            return text.rstrip(_WHITE_SPACE_CHARS) if right else text
        return strip
    if kind in ("NFC", "NFKC"):
        return lambda text: unicodedata.normalize(kind, text)
    if kind == "Lowercase":
        return str.lower
    if kind == "Precompiled" and not spec.get("precompiled_charsmap"):
        return lambda text: text
    raise _not_ported(f"normalizer {kind!r}"
                      + (" with a charsmap" if kind == "Precompiled" else ""))


def _metaspace(spec: Dict) -> Tuple[str, str, bool]:
    """(replacement, prepend scheme, split) of a Metaspace pre-tokenizer or
    decoder; the legacy ``add_prefix_space`` reads as "always" / "never"
    ("first", which hangs on the normalized text's original offsets, is
    not read)."""
    scheme = spec.get("prepend_scheme") or (
        "always" if spec.get("add_prefix_space", True) else "never")
    if scheme not in ("always", "never"):
        raise _not_ported(f"Metaspace prepend_scheme {scheme!r}")
    return spec.get("replacement", "▁"), scheme, bool(spec.get("split", True))


class UnigramTokenizer(_SnapshotTokenizer):
    """A Unigram (SentencePiece-style) tokenizer read from a
    ``tokenizer.json``, T5's format: the pieces and their scores, the
    unknown id, the normalizers of :func:`_normalizer`, the ``Metaspace``
    pre-tokenizer (optionally after ``WhitespaceSplit``, in a
    ``Sequence``) and decoder, and a ``TemplateProcessing`` post-processor
    (T5's appends ``</s>``).  Each segment is replaced space for ``▁``,
    given the prefix ``▁`` by the prepend scheme, split before each ``▁``,
    and each piece segmented by Viterbi over the pieces' scores, as the
    ``tokenizers`` package does: the best-scoring path, the first candidate
    (shortest, leftmost) among equal scores, a character no piece starts
    with costing the lowest score minus 10, runs of unknown characters
    fused into one unknown token.  Anything else (byte fallback, other
    components, a non-empty ``Precompiled`` charsmap) raises
    ``NotImplementedError``."""

    UNK_PENALTY = 10.0

    def __init__(self, spec: Dict, special_tokens: Optional[Dict] = None,
                 clean_up_tokenization_spaces: bool = False):
        model = spec.get("model") or {}
        if model.get("type") != "Unigram":
            raise _not_ported(f"tokenizer model {model.get('type')!r}")
        if model.get("byte_fallback"):
            raise _not_ported("Unigram byte_fallback")
        self._normalize = _normalizer(spec.get("normalizer"))
        pre = spec.get("pre_tokenizer") or {}
        parts = pre.get("pretokenizers", []) if pre.get("type") == "Sequence" \
            else [pre]
        self.whitespace_split = [p.get("type") for p in parts[:-1]] == \
            ["WhitespaceSplit"]
        if (not parts or parts[-1].get("type") != "Metaspace"
                or len(parts) > 1 + self.whitespace_split):
            raise _not_ported(f"pre-tokenizer {pre.get('type')!r}")
        self.replacement, self.prepend_scheme, self.split = \
            _metaspace(parts[-1])
        dec = spec.get("decoder")
        if dec is not None and dec.get("type") != "Metaspace":
            raise _not_ported(f"decoder {dec.get('type')!r}")
        self.decoder = _metaspace(dec) if dec is not None else None
        post = spec.get("post_processor")
        if post is not None and post.get("type") != "TemplateProcessing":
            raise _not_ported(f"post_processor {post.get('type')!r}")
        self.template = None
        if post is not None:
            specials = post.get("special_tokens") or {}
            self.template = []
            for item in post["single"]:
                if "Sequence" in item:
                    self.template.append(None)
                else:
                    self.template += specials[item["SpecialToken"]["id"]]["ids"]
        pieces = model["vocab"]
        self.scores = [float(s) for _, s in pieces]
        self.vocab = {}
        for i, (piece, _) in enumerate(pieces):
            self.vocab[piece] = i
        self.unk_id = model.get("unk_id")
        self.min_score = min(self.scores, default=0.0)
        self.max_piece = max((len(p) for p, _ in pieces), default=1)
        self._cache: Dict[str, List[int]] = {}
        super().__init__(spec, special_tokens, clean_up_tokenization_spaces)

    def _post_process(self, ids: List[int]) -> List[int]:
        if self.template is None:
            return ids
        out: List[int] = []
        for item in self.template:
            out += ids if item is None else [item]
        return out

    def _encode_segment(self, text: str) -> List[int]:
        words = (re.findall(f"[^{re.escape(_WHITE_SPACE_CHARS)}]+", text)
                 if self.whitespace_split else [text])
        ids: List[int] = []
        for word in words:
            word = word.replace(" ", self.replacement)
            if (self.prepend_scheme == "always"
                    and not word.startswith(self.replacement)):
                word = self.replacement + word
            if not self.split:
                pieces = [word] if word else []
            else:
                cuts = [i for i, c in enumerate(word)
                        if c == self.replacement and i > 0]
                pieces = [word[a:b] for a, b in
                          zip([0] + cuts, cuts + [len(word)]) if b > a]
            for piece in pieces:
                cached = self._cache.get(piece)
                if cached is None:
                    cached = self._cache[piece] = self._viterbi(piece)
                ids += cached
        return ids

    def _viterbi(self, text: str) -> List[int]:
        n = len(text)
        if not n:
            return []
        unk_score = self.min_score - self.UNK_PENALTY
        score = [0.0] * (n + 1)
        start: List[Optional[int]] = [None] * (n + 1)
        node_id = [0] * (n + 1)
        for i in range(n):
            here = score[i]
            single = False
            for j in range(i + 1, min(n, i + self.max_piece) + 1):
                tid = self.vocab.get(text[i:j])
                if tid is None:
                    continue
                cand = self.scores[tid] + here
                if start[j] is None or cand > score[j]:
                    score[j], start[j], node_id[j] = cand, i, tid
                single = single or j == i + 1
            if not single:
                if self.unk_id is None:
                    raise ValueError("Unigram model without an unknown id met "
                                     f"an unknown character in {text!r}")
                cand = unk_score + here
                if start[i + 1] is None or cand > score[i + 1]:
                    score[i + 1], start[i + 1], node_id[i + 1] = \
                        cand, i, self.unk_id
        # back from the end; runs of unknown pieces fuse into one token
        tokens: List[str] = []
        unk_run: List[str] = []
        end = n
        while end > 0:
            s = start[end]
            if node_id[end] == self.unk_id:
                unk_run.append(text[s:end])
            else:
                if unk_run:
                    tokens.append("".join(reversed(unk_run)))
                    unk_run = []
                tokens.append(text[s:end])
            end = s
        if unk_run:
            tokens.append("".join(reversed(unk_run)))
        return [self.vocab.get(t, self.unk_id) for t in reversed(tokens)]

    def _decode_tokens(self, tokens: List[str]) -> str:
        if self.decoder is None:
            return " ".join(tokens)
        rep, scheme, _ = self.decoder
        out = []
        for i, tok in enumerate(tokens):
            if i == 0 and scheme != "never":
                out.append(tok.replace(rep, ""))
            else:
                out.append(tok.replace(rep, " "))
        return "".join(out)


#: Qwen-1's split pattern (``tokenization_qwen.PAT_STR``)
_QWEN_PAT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
             r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
#: Qwen-1's special tokens, from id 151643 on
QWEN_SPECIAL_START = 151643
QWEN_SPECIALS = (("<|endoftext|>", "<|im_start|>", "<|im_end|>")
                 + tuple(f"<|extra_{i}|>" for i in range(205)))


@functools.lru_cache(maxsize=1)
def _qwen_split() -> "re.Pattern":
    """:data:`_QWEN_PAT` spelled for ``re`` (``\\p{L}``, ``\\p{N}`` and
    ``\\s`` as in :func:`_byte_level_split`)."""
    cats = [unicodedata.category(chr(cp))[0] for cp in range(0x110000)]
    letters = _class_ranges(lambda cp: cats[cp] == "L")
    numbers = _class_ranges(lambda cp: cats[cp] == "N")
    ws = _WHITE_SPACE
    return re.compile(
        rf"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n{letters}{numbers}]?[{letters}]+"
        rf"|[{numbers}]| ?[^{ws}{letters}{numbers}]+[\r\n]*|[{ws}]*[\r\n]+"
        rf"|[{ws}]+(?![^{ws}])|[{ws}]+")


class QwenTokenizer:
    """Qwen-1's tokenizer (``tokenization_qwen.QWenTokenizer``) read from
    its ``qwen.tiktoken``: one base64 token and its rank a line, byte-level
    BPE by rank (tiktoken's merge: the adjacent pair whose joined bytes
    have the lowest rank merges first, leftmost among equals), Qwen's split
    pattern, and its 208 special tokens from id 151643, split out of the
    text before the pattern runs.  Text is NFC-normalized first; no special
    token is added; decoding skips ids from ``<|endoftext|>`` on when asked
    to skip special tokens.  It names no EOS, pad or unknown token of its
    own (the loader's pad rule picks ``<|endoftext|>``)."""

    def __init__(self, ranks: Dict[bytes, int],
                 special_tokens: Optional[Dict] = None):
        self.ranks = ranks
        self.decoder_bytes = {i: t for t, i in ranks.items()}
        self.specials = {t: QWEN_SPECIAL_START + i
                         for i, t in enumerate(QWEN_SPECIALS)}
        self.special_tokens = dict(special_tokens or {})
        self._special_split = _alternation(self.specials)
        self._cache: Dict[bytes, List[int]] = {}

    def _token_id(self, name: str) -> Optional[int]:
        tok = self.special_tokens.get(name)
        return None if tok is None else self.get_vocab().get(tok)

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

    def get_vocab(self) -> Dict:
        return {**self.ranks, **self.specials}

    def __len__(self) -> int:
        return len(self.ranks) + len(self.specials)

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        text = unicodedata.normalize("NFC", text)
        ids: List[int] = []
        for seg, tid in _split_on(self._special_split, text, self.specials):
            if tid is not None:
                ids.append(tid)
                continue
            for m in _qwen_split().finditer(seg):
                piece = m.group(0).encode("utf-8")
                cached = self._cache.get(piece)
                if cached is None:
                    cached = self._cache[piece] = self._merge(piece)
                ids += cached
        return ids

    def _merge(self, piece: bytes) -> List[int]:
        rank = self.ranks.get(piece)
        if rank is not None:
            return [rank]
        parts = [piece[i:i + 1] for i in range(len(piece))]
        while len(parts) > 1:
            best, at = None, -1
            for i in range(len(parts) - 1):
                r = self.ranks.get(parts[i] + parts[i + 1])
                if r is not None and (best is None or r < best):
                    best, at = r, i
            if best is None:
                break
            parts[at:at + 2] = [parts[at] + parts[at + 1]]
        return [self.ranks[p] for p in parts]

    def __call__(self, text: Union[str, Sequence[str]],
                 add_special_tokens: bool = True) -> Encoding:
        if isinstance(text, str):
            return Encoding(input_ids=self.encode(text, add_special_tokens))
        return Encoding(input_ids=[self.encode(t, add_special_tokens)
                                   for t in text])

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        names = {i: t.encode("utf-8") for t, i in self.specials.items()}
        raw = bytearray()
        for i in ids:
            i = int(i)
            if skip_special_tokens and i >= QWEN_SPECIAL_START:
                continue
            raw += self.decoder_bytes.get(i, names.get(i, b""))
        return raw.decode("utf-8", errors="replace")


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


def _read_special_tokens(path: str) -> Tuple[Dict, Dict]:
    """(special tokens, tokenizer config) of a snapshot: the tokens of
    ``tokenizer_config.json`` overridden by ``special_tokens_map.json``, as
    transformers reads them."""
    special: Dict = {}
    config: Dict = {}
    for name in ("tokenizer_config.json", "special_tokens_map.json"):
        fname = os.path.join(path, name)
        if not os.path.exists(fname):
            continue
        with open(fname, encoding="utf-8") as f:
            conf = json.load(f)
        if name == "tokenizer_config.json":
            config = conf
        for key in ("bos_token", "eos_token", "unk_token", "pad_token"):
            if conf.get(key) is not None:
                special[key] = _special_token(conf[key])
        if conf.get("additional_special_tokens"):
            special["additional_special_tokens"] = [
                _special_token(t) for t in conf["additional_special_tokens"]]
    return special, config


def _bpe_spec_from_files(path: str) -> Dict:
    """A GPT-2-style snapshot's ``vocab.json`` and ``merges.txt`` as the
    ``tokenizer.json`` spec ``transformers`` converts them to: the BPE
    model, the ByteLevel pre-tokenizer (with the config's
    ``add_prefix_space``) and decoder, and ``added_tokens.json``'s tokens."""
    with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
        vocab = json.load(f)
    with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
        merges = [line.rstrip("\n") for line in f]
    merges = [m for i, m in enumerate(merges)
              if m and not (i == 0 and m.startswith("#version"))]
    added = []
    fname = os.path.join(path, "added_tokens.json")
    if os.path.exists(fname):
        with open(fname, encoding="utf-8") as f:
            added = [{"id": i, "content": t, "special": False, "normalized": True}
                     for t, i in json.load(f).items()]
    _, config = _read_special_tokens(path)
    return {"model": {"type": "BPE", "vocab": vocab, "merges": merges},
            "pre_tokenizer": {"type": "ByteLevel",
                              "add_prefix_space": bool(config.get(
                                  "add_prefix_space", False))},
            "decoder": {"type": "ByteLevel"}, "added_tokens": added}


def _read_tiktoken(fname: str) -> Dict[bytes, int]:
    with open(fname, "rb") as f:
        return {base64.b64decode(token): int(rank)
                for token, rank in (line.split() for line in f.read().splitlines()
                                    if line)}


def load_tokenizer(path: str):
    """A snapshot's tokenizer, read from the files it holds: a
    ``tokenizer.json`` (byte-level BPE, :class:`ByteLevelBPETokenizer`, or
    Unigram, :class:`UnigramTokenizer`), else Qwen-1's ``qwen.tiktoken``
    (:class:`QwenTokenizer`), else a ``vocab.json`` with ``merges.txt``
    (byte-level BPE, with the config's ``add_bos_token``); a SentencePiece
    ``tokenizer.model`` alone (Baichuan's) raises ``NotImplementedError``.
    Special tokens come from ``tokenizer_config.json`` overridden by
    ``special_tokens_map.json`` (as transformers reads them), with the
    reference loader's pad rule: without a pad token, the EOS token pads,
    else ``<|endoftext|>``, else the unknown token, else the token with the
    smallest id (pad positions are masked, so any id in range works)."""
    special, config = _read_special_tokens(path)
    clean_up = bool(config.get("clean_up_tokenization_spaces", False))
    fname = os.path.join(path, "tokenizer.json")
    if os.path.exists(fname):
        with open(fname, encoding="utf-8") as f:
            spec = json.load(f)
        kind = (spec.get("model") or {}).get("type")
        reader = UnigramTokenizer if kind == "Unigram" else ByteLevelBPETokenizer
        tok = reader(spec, special, clean_up)
    elif os.path.exists(os.path.join(path, "qwen.tiktoken")):
        tok = QwenTokenizer(_read_tiktoken(os.path.join(path, "qwen.tiktoken")),
                            special)
    elif all(os.path.exists(os.path.join(path, n))
             for n in ("vocab.json", "merges.txt")):
        tok = ByteLevelBPETokenizer(_bpe_spec_from_files(path), special,
                                    clean_up, bool(config.get("add_bos_token")))
    elif os.path.exists(os.path.join(path, "tokenizer.model")):
        raise _not_ported("a SentencePiece tokenizer.model")
    else:
        raise FileNotFoundError(f"no tokenizer files found under {path}")
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
