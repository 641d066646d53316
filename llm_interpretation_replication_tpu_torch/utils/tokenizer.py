"""Tokenizers with the interface the engine uses, without the
``tokenizers`` or ``transformers`` packages.

The engine needs only ``__call__`` (returning ``input_ids`` both as a key
and as an attribute), ``encode``, ``decode``, ``pad_token_id`` and
``eos_token_id``; a Hugging Face tokenizer has them, and so do
:class:`WordTokenizer` (a small word-level vocabulary; like a GPT-style one
it tells ``" Yes"`` from ``"Yes"``) and the readers of a snapshot's
tokenizer files (:func:`load_tokenizer`, the reader of the reference
loader's ``load_tokenizer``): :class:`ByteLevelBPETokenizer` (a BPE
``tokenizer.json``: GPT-2's, Falcon's, BLOOM's, Llama-2's and Mistral's
byte-fallback BPE; or ``vocab.json`` and ``merges.txt``),
:class:`UnigramTokenizer` (T5's Unigram ``tokenizer.json``, with its
Precompiled charsmap) and :class:`QwenTokenizer` (Qwen-1's
``qwen.tiktoken``).  The normalizers, pre-tokenizers, decoders and
post-processors around the models are :mod:`.tokenizer_parts`'.
"""

from __future__ import annotations

import base64
import heapq
import json
import os
import re
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple, Union

from . import tokenizer_parts as parts


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


_ITEM_TOK = parts.ITEM_TOK
_not_ported = parts.not_ported
_bytes_to_unicode = parts.bytes_to_unicode
_byte_level_split = parts.byte_level_split


def _clean_up_tokenization(text: str) -> str:
    """``transformers``' ``clean_up_tokenization``."""
    return (text.replace(" .", ".").replace(" ?", "?").replace(" !", "!")
            .replace(" ,", ",").replace(" ' ", "'").replace(" n't", "n't")
            .replace(" 'm", "'m").replace(" 's", "'s").replace(" 've", "'ve")
            .replace(" 're", "'re"))


class _SnapshotTokenizer:
    """What the readers of a snapshot's ``tokenizer.json`` share: the
    pipeline of :mod:`.tokenizer_parts` (normalizer, pre-tokenizer,
    post-processor, decoder), the added and special tokens, the pad / EOS /
    unknown tokens the tokenizer config names, the engine's interface, and
    the ``tokenizers`` package's order of encoding: split the raw text on
    the added tokens that are not normalized (longest first), normalize the
    rest, split that on the normalized added tokens, pre-tokenize each
    other segment and encode each of its pieces with the model
    (:meth:`_encode_word`).  A subclass sets ``self.vocab`` (token -> id)
    before calling ``__init__``."""

    vocab: Dict[str, int]

    def __init__(self, spec: Dict, special_tokens: Optional[Dict] = None,
                 clean_up_tokenization_spaces: bool = False):
        if spec.get("truncation") is not None:
            raise _not_ported("truncation")
        self._normalize = parts.normalizer(spec.get("normalizer"))
        self._pre = parts.pre_tokenizer(spec.get("pre_tokenizer"))
        self._post = parts.post_processor(spec.get("post_processor"))
        self._decode = parts.decoder(spec.get("decoder"))
        # a Metaspace "first" reads each piece's original offset
        self._offsets = self._pre.reads_offsets
        if self._offsets and not self._normalize.keeps_offsets:
            raise _not_ported("original offsets through this normalizer "
                              "(Metaspace prepend_scheme 'first' reads them)")
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
        """Token ids of ``text``, with the post-processor's special tokens
        when ``add_special_tokens``."""
        ids: List[int] = []
        for raw, tid, pos in _split_on(self._raw_split, text, self.added):
            if tid is not None:
                ids.append(tid)
                continue
            if self._offsets:
                norm, starts = self._normalize.aligned(
                    raw, list(range(pos, pos + len(raw))), pos)
            else:
                norm, starts = self._normalize(raw), None
            for piece, nid, at in _split_on(self._norm_split, norm,
                                            self._norm_added):
                if nid is not None:
                    ids.append(nid)
                    continue
                span = starts[at:at + len(piece)] if starts is not None else None
                for word, _ in self._pre([(piece, span)]):
                    cached = self._cache.get(word)
                    if cached is None:
                        cached = self._encode_word(word)
                        if len(word) < 256:
                            self._cache[word] = cached
                    ids += cached
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
        text = self._decode(tokens)
        if self.clean_up_tokenization_spaces:
            text = _clean_up_tokenization(text)
        return text

    def _post_process(self, ids: List[int]) -> List[int]:
        return self._post(ids)

    def _encode_word(self, word: str) -> List[int]:
        raise NotImplementedError


class ByteLevelBPETokenizer(_SnapshotTokenizer):
    """A BPE tokenizer read from a ``tokenizer.json`` (or built from a
    ``vocab.json`` and ``merges.txt``, :func:`load_tokenizer`): the ``BPE``
    model with its vocabulary and merge ranks, ``unk_token``, ``fuse_unk``,
    ``ignore_merges`` and ``byte_fallback`` (a character outside the
    vocabulary becomes its UTF-8 bytes as ``<0xXX>`` tokens when all of
    them are in it), behind any pipeline of :mod:`.tokenizer_parts`:
    GPT-2's lone ``ByteLevel``, Falcon's ``Sequence`` of Punctuation,
    ByteLevel, Digits and a ``Split``, BLOOM's ``Split`` and
    ``ByteLevel(use_regex=false)``, Llama's and Mistral's ``Prepend`` /
    ``Replace`` normalizers with the ``Replace`` / ``ByteFallback`` /
    ``Fuse`` / ``Strip`` decoders and a ``TemplateProcessing`` BOS, or a
    ``Metaspace`` pre-tokenizer and decoder (Mistral v0.3's "first").
    Each piece is merged by rank (the lowest-ranked pair first, leftmost
    among equals) over a heap of adjacent pairs.  With ``add_bos_token`` (a
    GPT-2-style tokenizer config's flag, as OPT's sets it) an encoding with
    special tokens starts with the BOS token.  Dropout, a continuing
    subword prefix or an end-of-word suffix raise ``NotImplementedError``."""

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
        # GPT-NeoX-20B's NFC normalizer, which the run-100q roster reads
        self.nfc = (spec.get("normalizer") or {}).get("type") == "NFC"
        self.byte_fallback = bool(model.get("byte_fallback", False))
        self.fuse_unk = bool(model.get("fuse_unk", False))
        self.ignore_merges = bool(model.get("ignore_merges", False))
        self.add_bos_token = bool(add_bos_token)
        self.vocab = dict(model["vocab"])
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(model.get("merges") or []):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            self.merges[(self.vocab[a], self.vocab[b])] = (rank,
                                                          self.vocab[a + b])
        self.unk = model.get("unk_token")
        self.unk_id = self.vocab.get(self.unk) if self.unk is not None else None
        self._byte_ids = [self.vocab.get(f"<0x{b:02X}>") for b in range(256)]
        super().__init__(spec, special_tokens, clean_up_tokenization_spaces)

    def _post_process(self, ids: List[int]) -> List[int]:
        ids = self._post(ids)
        bos = self._token_id("bos_token")
        if self.add_bos_token and bos is not None:
            return [bos] + ids
        return ids

    def _symbols(self, word: str) -> List[int]:
        """The package's ``merge_word`` before merging: a vocabulary id a
        character, else its ``<0xXX>`` byte tokens (byte fallback, all of
        them in the vocabulary), else the unknown token, a run of them
        fused into one with ``fuse_unk``.  A pending unknown token is
        written before the next known character, after byte tokens, as the
        package does."""
        syms: List[int] = []
        unk = False
        for c in word:
            tid = self.vocab.get(c)
            if tid is not None:
                if unk:
                    syms.append(self.unk_id)
                    unk = False
                syms.append(tid)
                continue
            if self.byte_fallback:
                got = [self._byte_ids[b] for b in c.encode("utf-8")]
                if None not in got:
                    syms += got
                    continue
            if self.unk is not None:
                if self.unk_id is None:
                    raise ValueError(f"BPE unk_token {self.unk!r} is not in "
                                     "the vocabulary")
                if unk and not self.fuse_unk:
                    syms.append(self.unk_id)
                unk = True
        if unk:
            syms.append(self.unk_id)
        return syms

    def _encode_word(self, word: str) -> List[int]:
        """Merge one pre-tokenized piece by rank: a heap of (rank,
        position) pairs, each popped pair merged if both symbols are still
        there, then its new neighbours pushed."""
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        syms = self._symbols(word)
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


def _has_byte_level(spec: Optional[Dict]) -> bool:
    if spec is None:
        return False
    return spec.get("type") == "ByteLevel" or any(
        _has_byte_level(s) for s in (spec.get("pretokenizers") or [])
        + (spec.get("decoders") or []))


class UnigramTokenizer(_SnapshotTokenizer):
    """A Unigram (SentencePiece-style) tokenizer read from a
    ``tokenizer.json``, T5's format: the pieces and their scores, the
    unknown id, and the pipeline of :mod:`.tokenizer_parts` around them
    (T5's ``Precompiled`` charsmap and ``Replace`` normalizers, a
    ``Metaspace`` pre-tokenizer and decoder at any prepend scheme,
    optionally after ``WhitespaceSplit``, and a ``TemplateProcessing``
    post-processor appending ``</s>``).  Each piece is segmented by Viterbi
    over the pieces' scores, as the ``tokenizers`` package does: the
    best-scoring path, the first candidate (shortest, leftmost) among
    equal scores, a character no piece starts with costing the lowest
    score minus 10, runs of unknown characters fused into one unknown
    token.  Byte fallback and a byte-level pre-tokenizer or decoder raise
    ``NotImplementedError``."""

    UNK_PENALTY = 10.0

    def __init__(self, spec: Dict, special_tokens: Optional[Dict] = None,
                 clean_up_tokenization_spaces: bool = False):
        model = spec.get("model") or {}
        if model.get("type") != "Unigram":
            raise _not_ported(f"tokenizer model {model.get('type')!r}")
        if model.get("byte_fallback"):
            raise _not_ported("Unigram byte_fallback")
        for key in ("pre_tokenizer", "decoder"):
            if _has_byte_level(spec.get(key)):
                raise _not_ported(f"a ByteLevel {key} before a Unigram model")
        pieces = model["vocab"]
        self.scores = [float(s) for _, s in pieces]
        self.vocab = {}
        for i, (piece, _) in enumerate(pieces):
            self.vocab[piece] = i
        self.unk_id = model.get("unk_id")
        self.min_score = min(self.scores, default=0.0)
        self.max_piece = max((len(p) for p, _ in pieces), default=1)
        super().__init__(spec, special_tokens, clean_up_tokenization_spaces)

    def _encode_word(self, text: str) -> List[int]:
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


#: Qwen-1's split pattern (``tokenization_qwen.PAT_STR``)
_QWEN_PAT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
             r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
#: Qwen-1's special tokens, from id 151643 on
QWEN_SPECIAL_START = 151643
QWEN_SPECIALS = (("<|endoftext|>", "<|im_start|>", "<|im_end|>")
                 + tuple(f"<|extra_{i}|>" for i in range(205)))


def _qwen_split() -> "re.Pattern":
    """:data:`_QWEN_PAT` spelled for ``re`` (``\\p{L}``, ``\\p{N}`` and
    ``\\s`` as Unicode classes, :func:`.tokenizer_parts.onig_regex`)."""
    return parts.onig_regex(_QWEN_PAT)


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
        for seg, tid, _ in _split_on(self._special_split, text,
                                     self.specials):
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
    """``text`` as ``(segment, None, offset)`` and ``(token, id, offset)``
    pieces, split where ``pattern`` matches one of the tokens ``ids``
    names; empty segments are left out."""
    pos = 0
    for m in (pattern.finditer(text) if pattern is not None else ()):
        if m.start() > pos:
            yield text[pos:m.start()], None, pos
        yield m.group(0), ids[m.group(0)], m.start()
        pos = m.end()
    if pos < len(text):
        yield text[pos:], None, pos


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


#: transformers' ``LlamaTokenizerFast`` (Llama-2's and Mistral's tokenizer
#: class) and the special tokens it names when the config names none
_LLAMA_CLASSES = ("LlamaTokenizer", "LlamaTokenizerFast")
_LLAMA_SPECIALS = {"bos_token": "<s>", "eos_token": "</s>",
                   "unk_token": "<unk>"}


def _llama_template(tok, config: Dict):
    """``LlamaTokenizerFast.update_post_processor``: BOS in front when
    ``add_bos_token`` (default on), EOS behind when ``add_eos_token``
    (default off), whatever the file's post-processor says."""
    front = [tok._token_id("bos_token")] if config.get("add_bos_token",
                                                       True) else []
    back = [tok._token_id("eos_token")] if config.get("add_eos_token",
                                                      False) else []
    return lambda ids: front + ids + back


def load_tokenizer(path: str):
    """A snapshot's tokenizer, read from the files it holds: a
    ``tokenizer.json`` (a BPE model, :class:`ByteLevelBPETokenizer`, or a
    Unigram one, :class:`UnigramTokenizer`, each behind the pipeline
    components of :mod:`.tokenizer_parts`), else Qwen-1's
    ``qwen.tiktoken`` (:class:`QwenTokenizer`), else a ``vocab.json`` with
    ``merges.txt`` (byte-level BPE, with the config's ``add_bos_token``);
    a SentencePiece ``tokenizer.model`` or ``spiece.model`` alone
    (Baichuan's, ChatGLM's, a T5 snapshot without ``tokenizer.json``)
    raises ``NotImplementedError``.  As transformers loads them: special
    tokens come from ``tokenizer_config.json`` overridden by
    ``special_tokens_map.json``; a top-level ``ByteLevel`` pre-tokenizer
    takes the config's ``add_prefix_space`` (default off); the LLaMA
    ``tokenizer_class`` names ``<s>``, ``</s>`` and ``<unk>`` unless the config names
    others and sets the BOS/EOS template from ``add_bos_token`` /
    ``add_eos_token``.  Then the reference loader's pad rule: without a
    pad token, the EOS token pads, else ``<|endoftext|>``, else the
    unknown token, else the token with the smallest id (pad positions are
    masked, so any id in range works)."""
    special, config = _read_special_tokens(path)
    clean_up = bool(config.get("clean_up_tokenization_spaces", False))
    llama = config.get("tokenizer_class") in _LLAMA_CLASSES
    if llama:
        special = {**_LLAMA_SPECIALS, **special}
    fname = os.path.join(path, "tokenizer.json")
    if os.path.exists(fname):
        with open(fname, encoding="utf-8") as f:
            spec = json.load(f)
        pre = spec.get("pre_tokenizer") or {}
        if pre.get("type") == "ByteLevel":
            spec["pre_tokenizer"] = dict(pre, add_prefix_space=bool(
                config.get("add_prefix_space", False)))
        kind = (spec.get("model") or {}).get("type")
        reader = UnigramTokenizer if kind == "Unigram" else ByteLevelBPETokenizer
        tok = reader(spec, special, clean_up)
        if llama:
            tok._post = _llama_template(tok, config)
    elif os.path.exists(os.path.join(path, "qwen.tiktoken")):
        tok = QwenTokenizer(_read_tiktoken(os.path.join(path, "qwen.tiktoken")),
                            special)
    elif all(os.path.exists(os.path.join(path, n))
             for n in ("vocab.json", "merges.txt")):
        tok = ByteLevelBPETokenizer(_bpe_spec_from_files(path), special,
                                    clean_up, bool(config.get("add_bos_token")))
    elif any(os.path.exists(os.path.join(path, n))
             for n in ("tokenizer.model", "spiece.model")):
        raise _not_ported("a SentencePiece tokenizer.model / spiece.model")
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
