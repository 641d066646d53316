"""The components of a ``tokenizer.json`` pipeline, read as the
``tokenizers`` package runs them, with the standard library only.

- **Normalizers** (:func:`normalizer`): ``Sequence``, ``NFC``/``NFD``/
  ``NFKC``/``NFKD``, ``Lowercase``, ``Strip``, ``Prepend``, ``Replace``
  (a string or an Oniguruma regex) and ``Precompiled`` (a SentencePiece
  charsmap: a darts-clone double array and its normalized strings, looked
  up a grapheme cluster at a time).
- **Pre-tokenizers** (:func:`pre_tokenizer`): ``Sequence`` of
  ``ByteLevel``, ``Split``, ``Punctuation``, ``Digits``, ``Whitespace``,
  ``WhitespaceSplit`` and ``Metaspace`` (every prepend scheme, ``split``
  on and off).  Each splits the pieces the previous one left, with the
  package's five split behaviours.
- **Decoders** (:func:`decoder`): ``ByteLevel``, ``Metaspace``,
  ``Replace``, ``ByteFallback``, ``Fuse``, ``Strip`` and ``Sequence``.
- **Post-processors** (:func:`post_processor`): ``ByteLevel`` (ids
  unchanged), ``TemplateProcessing`` (its single template) and
  ``Sequence`` of those.

Regexes (``Split`` patterns, ``Replace`` patterns) are Oniguruma's;
:func:`onig_regex` translates them to ``re`` (nested and intersected
character classes flattened, ``\\p{..}``, ``\\s``, ``\\w`` and ``\\d``
spelled as Unicode classes of this Python's ``unicodedata``) and
:func:`find_matches` walks them as the Oniguruma crate does (no empty
match right after the previous match).  A component, option or regex
construct not listed raises ``NotImplementedError`` naming ROADMAP.md's
"Snapshot tokenizers" item.

A piece of text travels with the original offset of each of its
characters when a ``Metaspace`` pre-tokenizer's ``"first"`` scheme reads
them (it prepends only to the piece that starts at offset 0 of the
original text); the normalizers that keep those offsets
(``Lowercase``, ``Strip``, ``Prepend``, ``Replace``) carry them as the
package's alignments do.
"""

from __future__ import annotations

import base64
import functools
import re
import struct
import unicodedata
from typing import Callable, Dict, List, Optional, Tuple

ITEM_TOK = "ROADMAP.md queue 1, 'Snapshot tokenizers'"

#: Unicode's White_Space property: the ``\\s`` of the Oniguruma patterns
#: the ``tokenizers`` package compiles (Python's ``\\s`` adds U+001C-U+001F)
WHITE_SPACE = ("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029"
               "\u202f\u205f\u3000")
WHITE_SPACE_CHARS = ("\t\n\x0b\x0c\r \x85\xa0\u1680"
                     + "".join(map(chr, range(0x2000, 0x200B)))
                     + "\u2028\u2029\u202f\u205f\u3000")
_WS_SET = frozenset(WHITE_SPACE_CHARS)
MAX_CP = 0x10FFFF


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({ITEM_TOK})")


# -- Unicode classes -------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _categories() -> List[str]:
    """The general category of every code point (this Python's
    ``unicodedata``), built once on first use (about a second)."""
    return [unicodedata.category(chr(cp)) for cp in range(MAX_CP + 1)]


Ranges = List[Tuple[int, int]]


def _ranges_of(pred) -> Ranges:
    out: Ranges = []
    start = None
    for cp in range(MAX_CP + 1):
        if pred(cp):
            if start is None:
                start = cp
        elif start is not None:
            out.append((start, cp - 1))
            start = None
    if start is not None:
        out.append((start, MAX_CP))
    return out


def _union(*sets: Ranges) -> Ranges:
    spans = sorted(r for s in sets for r in s)
    out: Ranges = []
    for lo, hi in spans:
        if out and lo <= out[-1][1] + 1:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _complement(s: Ranges) -> Ranges:
    out: Ranges = []
    nxt = 0
    for lo, hi in _union(s):
        if lo > nxt:
            out.append((nxt, lo - 1))
        nxt = hi + 1
    if nxt <= MAX_CP:
        out.append((nxt, MAX_CP))
    return out


def _intersect(a: Ranges, b: Ranges) -> Ranges:
    return _complement(_union(_complement(a), _complement(b)))


def _chars(text: str) -> Ranges:
    return _union([(ord(c), ord(c)) for c in text])


@functools.lru_cache(maxsize=None)
def _category_set(prefix: str) -> Tuple[Tuple[int, int], ...]:
    """The code points whose general category starts with ``prefix``
    (``"L"``, ``"Nd"``, ...)."""
    cats = _categories()
    return tuple(_ranges_of(lambda cp: cats[cp].startswith(prefix)))


def _cats(*prefixes: str) -> Ranges:
    return _union(*(list(_category_set(p)) for p in prefixes))


def _white_space() -> Ranges:
    return _chars(WHITE_SPACE_CHARS)


#: Other_Alphabetic beyond the marks: the circled and squared letters
_OTHER_ALPHABETIC_SYMBOLS = [(0x24B6, 0x24E9), (0x1F130, 0x1F149),
                             (0x1F150, 0x1F169), (0x1F170, 0x1F189)]


def _onig_word() -> Ranges:
    """Oniguruma's ``\\w``: below U+0100 its ISO-8859-1 table (ASCII
    letters, digits and ``_``, ``ª µ º``, the superscript digits and
    vulgar fractions, the Latin-1 letters), above it Alphabetic (L, Nl,
    Other_Alphabetic), marks, Nd and Pc."""
    latin1 = _chars("_ªµº²³¹¼½¾") + [(0x30, 0x39), (0x41, 0x5A),
                                       (0x61, 0x7A), (0xC0, 0xD6),
                                       (0xD8, 0xF6), (0xF8, 0xFF)]
    wide = _intersect(_union(_cats("L", "Nl", "M", "Nd", "Pc"),
                             _OTHER_ALPHABETIC_SYMBOLS),
                      [(0x100, MAX_CP)])
    return _union(latin1, wide)


#: the Oniguruma escapes and their Unicode classes: ``\\w`` word
#: characters (``_onig_word``), ``\\d`` Decimal_Number, ``\\s``
#: White_Space, ``\\h`` a hex digit
_ESCAPE_SETS: Dict[str, Callable[[], Ranges]] = {
    "s": _white_space,
    "d": lambda: _cats("Nd"),
    "w": _onig_word,
    "h": lambda: _chars("0123456789abcdefABCDEF"),
}

def _property_set(name: str) -> Ranges:
    """``\\p{name}``: a general category by its one- or two-letter
    abbreviation."""
    if (len(name) in (1, 2) and name[0] in "LMNPSZC"
            and (len(name) == 1 or name[1].islower())):
        found = _cats(name)
        if found or name in ("Cs", "Co", "Cn"):
            return found
    raise not_ported(f"the Oniguruma property \\p{{{name}}}")


def class_body(ranges: Ranges) -> str:
    """A ``re`` character class (brackets included) of ``ranges``."""
    if not ranges:
        return "(?!)"
    parts = []
    for lo, hi in ranges:
        a = re.escape(chr(lo))
        parts.append(a if lo == hi else f"{a}-{re.escape(chr(hi))}")
    return "[" + "".join(parts) + "]"


# -- Oniguruma regexes -----------------------------------------------------------

_SIMPLE_ESCAPES = {"t": "\t", "n": "\n", "r": "\r", "f": "\f", "v": "\v",
                   "a": "\a", "e": "\x1b"}


class _OnigTranslator:
    """One Oniguruma (Ruby syntax) pattern spelled for ``re``."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        self.multiline = False

    def fail(self, what: str):
        raise not_ported(f"the Oniguruma construct {what} in "
                         f"{self.p!r} (at {self.i})")

    def translate(self) -> str:
        out = []
        p, n = self.p, len(self.p)
        while self.i < n:
            c = p[self.i]
            if c == "\\":
                out.append(self._escape_outside())
            elif c == "[":
                out.append(class_body(self._class()))
            elif c == "(":
                out.append(self._group_open())
            elif c in ")|.*+?":
                out.append(c)
                self.i += 1
            elif c == "{":
                out.append(self._interval())
            elif c in "^$":
                self.multiline = True      # Ruby's anchors are line anchors
                out.append(c)
                self.i += 1
            else:
                out.append(re.escape(c))
                self.i += 1
        return "".join(out)

    def _group_open(self) -> str:
        p, i = self.p, self.i
        for opener in ("(?:", "(?=", "(?!", "(?<=", "(?<!", "(?>"):
            if p.startswith(opener, i):
                self.i += len(opener)
                return opener
        if p.startswith("(?i:", i):
            body_end = self._group_end(i)
            if not all(ord(ch) < 128 for ch in p[i + 4:body_end]):
                self.fail("(?i:...) over text outside ASCII")
            self.i += 4
            return "(?i:"
        if p.startswith("(?", i):
            self.fail(p[i:i + 3])
        self.i += 1
        return "("

    def _group_end(self, start: int) -> int:
        depth, j, p = 0, start, self.p
        while j < len(p):
            if p[j] == "\\":
                j += 2
                continue
            if p[j] == "(":
                depth += 1
            elif p[j] == ")":
                depth -= 1
                if depth == 0:
                    return j
            j += 1
        self.fail("an unbalanced group")

    def _interval(self) -> str:
        m = re.compile(r"\{(\d+)?(,)?(\d+)?\}").match(self.p, self.i)
        if m is None or (m.group(1) is None and m.group(3) is None):
            self.i += 1
            return re.escape("{")
        self.i = m.end()
        if self.p.startswith("+", self.i):
            self.fail("an interval followed by '+'")
        return m.group(0)

    def _escape_outside(self) -> str:
        p, i = self.p, self.i
        if i + 1 >= len(p):
            self.fail("a trailing backslash")
        c = p[i + 1]
        if c in "AzZbB":
            self.i += 2
            if c == "A":
                return r"\A"
            if c == "z":
                return r"\Z"
            if c == "Z":
                return r"(?=\n?\Z)"
            word = class_body(_ESCAPE_SETS["w"]())
            edge = (rf"(?:(?<={word})(?!{word})|(?<!{word})(?={word}))")
            return edge if c == "b" else (
                rf"(?:(?<={word})(?={word})|(?<!{word})(?!{word}))")
        got = self._escape()
        return class_body(got) if isinstance(got, list) else re.escape(got)

    def _escape(self):
        """The escape at ``self.i``: a character (str) or a set (ranges)."""
        p, i = self.p, self.i
        if i + 1 >= len(p):
            self.fail("a trailing backslash")
        c = p[i + 1]
        if c.lower() in _ESCAPE_SETS:
            self.i += 2
            s = _ESCAPE_SETS[c.lower()]()
            return _complement(s) if c.isupper() else s
        if c in "pP":
            m = re.compile(r"\{(\^?)(\w+)\}").match(p, i + 2)
            if m is None:
                self.fail(p[i:i + 3])
            self.i = m.end()
            s = _property_set(m.group(2))
            return _complement(s) if (c == "P") != bool(m.group(1)) else s
        if c in _SIMPLE_ESCAPES:
            self.i += 2
            return _SIMPLE_ESCAPES[c]
        if c == "x":
            m = (re.compile(r"\{([0-9A-Fa-f]{1,8})\}").match(p, i + 2)
                 or re.compile(r"([0-9A-Fa-f]{1,2})").match(p, i + 2))
            if m is None:
                self.fail("\\x")
            self.i = m.end()
            return chr(int(m.group(1), 16))
        if c == "u":
            m = re.compile(r"[0-9A-Fa-f]{4}").match(p, i + 2)
            if m is None:
                self.fail("\\u")
            self.i = m.end()
            return chr(int(m.group(0), 16))
        if c.isalnum() or c == "_":
            self.fail("\\" + c)
        self.i += 2
        return c

    def _class(self) -> Ranges:
        """A bracketed class at ``self.i`` (nested classes, ``&&``,
        negation, ranges and escapes), as code point ranges."""
        self.i += 1
        neg = self.p.startswith("^", self.i)
        if neg:
            self.i += 1
        out = self._class_items()
        return _complement(out) if neg else out

    def _class_items(self) -> Ranges:
        """A class body up to and including its closing ``]``."""
        p = self.p
        items: List[Ranges] = []
        first = True
        while True:
            if self.i >= len(p):
                self.fail("an unterminated class")
            c = p[self.i]
            if c == "]" and not first:
                self.i += 1
                return _union(*items)
            if p.startswith("[:", self.i):
                self.fail("a POSIX bracket")
            if c == "[":
                items.append(self._class())
            elif p.startswith("&&", self.i):
                self.i += 2
                return _intersect(_union(*items), self._class_items())
            else:
                lo = self._class_atom()
                if isinstance(lo, list):
                    items.append(lo)
                elif (p.startswith("-", self.i) and self.i + 1 < len(p)
                        and p[self.i + 1] != "]"):
                    self.i += 1
                    hi = self._class_atom()
                    if isinstance(hi, list) or ord(hi) < ord(lo):
                        self.fail("a class range")
                    items.append([(ord(lo), ord(hi))])
                else:
                    items.append([(ord(lo), ord(lo))])
            first = False

    def _class_atom(self):
        c = self.p[self.i]
        if c == "\\":
            return self._escape()
        self.i += 1
        return c


@functools.lru_cache(maxsize=None)
def onig_regex(pattern: str) -> "re.Pattern":
    """An Oniguruma pattern compiled with ``re``; a construct the
    translation does not take raises ``NotImplementedError``."""
    tr = _OnigTranslator(pattern)
    body = tr.translate()
    try:
        return re.compile(body, re.M if tr.multiline else 0)
    except re.error as err:
        raise not_ported(f"the Oniguruma pattern {pattern!r} ({err})")


def find_iter(regex: "re.Pattern", text: str) -> List[Tuple[int, int]]:
    """(start, end) of each match as the Oniguruma crate's ``find_iter``
    yields them: an empty match right after the previous match is
    skipped (``re.finditer`` keeps it)."""
    out: List[Tuple[int, int]] = []
    pos, last = 0, None
    n = len(text)
    while pos <= n:
        m = regex.search(text, pos)
        if m is None:
            break
        s, e = m.span()
        if s == e and last == e:
            pos += 1
            continue
        out.append((s, e))
        pos = last = e
    return out


Match = Tuple[int, int, bool]


def find_matches(regex: "re.Pattern", text: str) -> List[Match]:
    """The package's ``Pattern::find_matches`` of a regex: ``text`` cut
    into (start, end, is_match) spans that cover it."""
    if not text:
        return [(0, 0, False)]
    out: List[Match] = []
    prev = 0
    for s, e in find_iter(regex, text):
        if prev != s:
            out.append((prev, s, False))
        out.append((s, e, True))
        prev = e
    if prev != len(text):
        out.append((prev, len(text), False))
    return out


def char_matches(pred: Callable[[str], bool], text: str) -> List[Match]:
    """``find_matches`` of a character predicate: each accepted character
    is a match of its own."""
    if not text:
        return [(0, 0, False)]
    out: List[Match] = []
    last = 0
    for i, c in enumerate(text):
        if pred(c):
            if last < i:
                out.append((last, i, False))
            out.append((i, i + 1, True))
            last = i + 1
    if len(text) > last:
        out.append((last, len(text), False))
    return out


BEHAVIORS = ("removed", "isolated", "merged_with_previous",
             "merged_with_next", "contiguous")


def _behavior(spec_value) -> str:
    b = str(spec_value).lower()
    b = {"mergedwithprevious": "merged_with_previous",
         "mergedwithnext": "merged_with_next"}.get(b, b)
    if b not in BEHAVIORS:
        raise not_ported(f"the split behavior {spec_value!r}")
    return b


def split_spans(matches: List[Match], behavior: str) -> List[Tuple[int, int]]:
    """The package's ``NormalizedString::split``: the kept (start, end)
    spans of ``matches`` under ``behavior``."""
    if behavior == "isolated":
        return [(s, e) for s, e, _ in matches]
    if behavior == "removed":
        return [(s, e) for s, e, m in matches if not m]
    acc: List[List[int]] = []
    prev = False
    if behavior == "merged_with_next":
        for s, e, m in reversed(matches):
            if m and not prev and acc:
                acc[-1][0] = s
            else:
                acc.append([s, e])
            prev = m
        return [(s, e) for s, e in reversed(acc)]
    for s, e, m in matches:
        merge = (m == prev) if behavior == "contiguous" else (m and not prev)
        if merge and acc:
            acc[-1][1] = e
        else:
            acc.append([s, e])
        prev = m
    return [(s, e) for s, e in acc]


# -- pieces ------------------------------------------------------------------------

#: a piece of text and the original offset of each of its characters
#: (None when no component reads offsets)
Piece = Tuple[str, Optional[List[int]]]


def _cut(piece: Piece, spans) -> List[Piece]:
    text, starts = piece
    return [(text[s:e], starts[s:e] if starts is not None else None)
            for s, e in spans if e > s]


# -- normalizers -----------------------------------------------------------------

class Normalizer:
    """A normalizer: ``__call__`` maps text; ``aligned`` maps text with the
    original offset of each character (``origin``: the offset of the
    segment's start); ``keeps_offsets`` says whether it can."""

    keeps_offsets = True

    def __call__(self, text: str) -> str:
        raise NotImplementedError

    def aligned(self, text: str, starts: List[int], origin: int):
        raise not_ported(f"original offsets through {type(self).__name__}")


class _Identity(Normalizer):
    def __call__(self, text):
        return text

    def aligned(self, text, starts, origin):
        return text, starts


class _SequenceNorm(Normalizer):
    def __init__(self, parts):
        self.parts = parts
        self.keeps_offsets = all(p.keeps_offsets for p in parts)

    def __call__(self, text):
        for part in self.parts:
            text = part(text)
        return text

    def aligned(self, text, starts, origin):
        for part in self.parts:
            text, starts = part.aligned(text, starts, origin)
        return text, starts


class _UnicodeForm(Normalizer):
    keeps_offsets = False

    def __init__(self, form):
        self.form = form

    def __call__(self, text):
        return unicodedata.normalize(self.form, text)


class _Lowercase(Normalizer):
    """Rust's ``char::to_lowercase`` a character at a time (no final
    sigma, unlike ``str.lower``)."""

    def __call__(self, text):
        return "".join(c.lower() for c in text)

    def aligned(self, text, starts, origin):
        out, pos = [], []
        for c, s in zip(text, starts):
            low = c.lower()
            out.append(low)
            pos += [s] * len(low)
        return "".join(out), pos


class _Strip(Normalizer):
    def __init__(self, left, right):
        self.left, self.right = left, right

    def _span(self, text):
        a, b = 0, len(text)
        if self.left:
            while a < b and text[a] in _WS_SET:
                a += 1
        if self.right:
            while b > a and text[b - 1] in _WS_SET:
                b -= 1
        return a, b

    def __call__(self, text):
        a, b = self._span(text)
        return text[a:b]

    def aligned(self, text, starts, origin):
        a, b = self._span(text)
        return text[a:b], starts[a:b]


class _Prepend(Normalizer):
    def __init__(self, prepend):
        self.prepend = prepend

    def __call__(self, text):
        return self.prepend + text if text else text

    def aligned(self, text, starts, origin):
        if not text:
            return text, starts
        return self.prepend + text, [starts[0]] * len(self.prepend) + starts


def _pattern(spec) -> "re.Pattern":
    """A ``Replace``/``Split`` pattern: ``{"String": s}`` (literal) or
    ``{"Regex": r}`` (Oniguruma)."""
    if "Regex" in spec:
        return onig_regex(spec["Regex"])
    return re.compile(re.escape(spec["String"]))


class _Replace(Normalizer):
    def __init__(self, spec):
        self.literal = spec["pattern"].get("String")
        self.regex = _pattern(spec["pattern"])
        self.content = spec["content"]

    def __call__(self, text):
        if self.literal:
            return text.replace(self.literal, self.content)
        return "".join(self.content if m else text[s:e]
                       for s, e, m in find_matches(self.regex, text))

    def aligned(self, text, starts, origin):
        out, pos = [], []
        for s, e, m in find_matches(self.regex, text):
            if not m:
                out.append(text[s:e])
                pos += starts[s:e]
            else:
                # inserted characters take the alignment of the last
                # character the match replaced (the segment's start for
                # an empty match at 0)
                at = starts[e - 1] if e > 0 else origin
                out.append(self.content)
                pos += [at] * len(self.content)
        return "".join(out), pos


class Precompiled(Normalizer):
    """SentencePiece's precompiled charsmap (``spm_precompiled``): a
    little-endian u32 trie size in bytes, that many bytes of a darts-clone
    double array (u32 units), then NUL-terminated normalized strings.
    Normalizing looks each grapheme cluster shorter than 6 UTF-8 bytes up
    whole and, failing that, each of its characters: a lookup is a
    common-prefix search of the key's bytes whose first (shortest) result
    replaces the whole key."""

    keeps_offsets = False

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError("Cannot parse precompiled_charsmap")
        (size,) = struct.unpack_from("<I", blob)
        n = size // 4
        if len(blob) < 4 + 4 * n:
            raise ValueError("Cannot parse precompiled_charsmap")
        self.units = struct.unpack_from(f"<{n}I", blob, 4)
        self.normalized = bytes(blob[4 + 4 * n:])
        self.normalized.decode("utf-8")      # the package requires UTF-8

    def _unit(self, pos: int) -> int:
        if not 0 <= pos < len(self.units):
            raise ValueError(f"precompiled charsmap read past its trie at {pos}")
        return self.units[pos]

    @staticmethod
    def _offset(unit: int) -> int:
        return (unit >> 10) << ((unit & (1 << 9)) >> 6)

    def common_prefix_search(self, key: bytes) -> List[int]:
        """The values of the trie's keys that are prefixes of ``key``,
        shortest first."""
        results = []
        node = self._offset(self._unit(0))
        for c in key:
            if c == 0:
                break
            node ^= c
            unit = self._unit(node)
            if unit & ((1 << 31) | 0xFF) != c:
                return results
            node ^= self._offset(unit)
            if (unit >> 8) & 1:
                results.append(self._unit(node) & ((1 << 31) - 1))
        return results

    def transform(self, chunk: str) -> Optional[str]:
        """The normalized text of the first key that prefixes ``chunk``."""
        found = self.common_prefix_search(chunk.encode("utf-8"))
        if not found:
            return None
        end = self.normalized.find(b"\0", found[0])
        end = len(self.normalized) if end < 0 else end
        return self.normalized[found[0]:end].decode("utf-8")

    def __call__(self, text):
        out = []
        for g in graphemes(text):
            if len(g.encode("utf-8")) < 6:
                norm = self.transform(g)
                if norm is not None:
                    out.append(norm)
                    continue
            for c in g:
                norm = self.transform(c)
                out.append(c if norm is None else norm)
        return "".join(out)


def normalizer(spec: Optional[Dict]) -> Normalizer:
    """A ``tokenizer.json`` normalizer; anything not listed in this
    module's docstring raises ``NotImplementedError``."""
    if spec is None:
        return _Identity()
    kind = spec.get("type")
    if kind == "Sequence":
        return _SequenceNorm([normalizer(s) for s in
                              spec.get("normalizers") or []])
    if kind == "Replace":
        return _Replace(spec)
    if kind == "Strip":
        return _Strip(spec.get("strip_left", True), spec.get("strip_right", True))
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return _UnicodeForm(kind)
    if kind == "Lowercase":
        return _Lowercase()
    if kind == "Prepend":
        return _Prepend(spec["prepend"])
    if kind == "Precompiled":
        charsmap = spec.get("precompiled_charsmap")
        if not charsmap:
            return _Identity()
        return Precompiled(base64.b64decode(charsmap))
    raise not_ported(f"normalizer {kind!r}")


# -- grapheme clusters (UAX #29, extended) ---------------------------------------

_PREPEND = _union([(0x600, 0x605), (0x6DD, 0x6DD), (0x70F, 0x70F),
                   (0x890, 0x891), (0x8E2, 0x8E2), (0xD4E, 0xD4E),
                   (0x110BD, 0x110BD), (0x110CD, 0x110CD),
                   (0x111C2, 0x111C3), (0x1193F, 0x1193F),
                   (0x11941, 0x11941), (0x11A3A, 0x11A3A),
                   (0x11A84, 0x11A89), (0x11D46, 0x11D46),
                   (0x11F02, 0x11F02)])
#: Other_Grapheme_Extend, the emoji modifiers and the tag characters
_EXTEND_EXTRA = _union([(0x9BE, 0x9BE), (0x9D7, 0x9D7), (0xB3E, 0xB3E),
                        (0xB57, 0xB57), (0xBBE, 0xBBE), (0xBD7, 0xBD7),
                        (0xCC2, 0xCC2), (0xCD5, 0xCD6), (0xD3E, 0xD3E),
                        (0xD57, 0xD57), (0xDCF, 0xDCF), (0xDDF, 0xDDF),
                        (0x1B35, 0x1B35), (0x200C, 0x200C),
                        (0x302E, 0x302F), (0xFF9E, 0xFF9F),
                        (0x1133E, 0x1133E), (0x11357, 0x11357),
                        (0x114B0, 0x114B0), (0x114BD, 0x114BD),
                        (0x115AF, 0x115AF), (0x11930, 0x11930),
                        (0x1D165, 0x1D165), (0x1D16E, 0x1D172),
                        (0x1F3FB, 0x1F3FF), (0xE0020, 0xE007F)])
#: spacing marks whose Grapheme_Cluster_Break is Other
_MC_OTHER = _union([(0x102B, 0x102C), (0x1038, 0x1038), (0x1062, 0x1064),
                    (0x1067, 0x106D), (0x1083, 0x1083), (0x1087, 0x108C),
                    (0x108F, 0x108F), (0x109A, 0x109C), (0x1A61, 0x1A61),
                    (0x1A63, 0x1A64), (0xAA7B, 0xAA7B), (0xAA7D, 0xAA7D),
                    (0x11720, 0x11721)])
#: Extended_Pictographic (emoji-data.txt)
_EXT_PICT = _union([
    (0xA9, 0xA9), (0xAE, 0xAE), (0x203C, 0x203C), (0x2049, 0x2049),
    (0x2122, 0x2122), (0x2139, 0x2139), (0x2194, 0x2199), (0x21A9, 0x21AA),
    (0x231A, 0x231B), (0x2328, 0x2328), (0x2388, 0x2388), (0x23CF, 0x23CF),
    (0x23E9, 0x23F3), (0x23F8, 0x23FA), (0x24C2, 0x24C2), (0x25AA, 0x25AB),
    (0x25B6, 0x25B6), (0x25C0, 0x25C0), (0x25FB, 0x25FE), (0x2600, 0x2605),
    (0x2607, 0x2612), (0x2614, 0x2685), (0x2690, 0x2705), (0x2708, 0x2712),
    (0x2714, 0x2714), (0x2716, 0x2716), (0x271D, 0x271D), (0x2721, 0x2721),
    (0x2728, 0x2728), (0x2733, 0x2734), (0x2744, 0x2744), (0x2747, 0x2747),
    (0x274C, 0x274C), (0x274E, 0x274E), (0x2753, 0x2755), (0x2757, 0x2757),
    (0x2763, 0x2767), (0x2795, 0x2797), (0x27A1, 0x27A1), (0x27B0, 0x27B0),
    (0x27BF, 0x27BF), (0x2934, 0x2935), (0x2B05, 0x2B07), (0x2B1B, 0x2B1C),
    (0x2B50, 0x2B50), (0x2B55, 0x2B55), (0x3030, 0x3030), (0x303D, 0x303D),
    (0x3297, 0x3297), (0x3299, 0x3299), (0x1F000, 0x1F0FF),
    (0x1F10D, 0x1F10F), (0x1F12F, 0x1F12F), (0x1F16C, 0x1F171),
    (0x1F17E, 0x1F17F), (0x1F18E, 0x1F18E), (0x1F191, 0x1F19A),
    (0x1F1AD, 0x1F1E5), (0x1F201, 0x1F20F), (0x1F21A, 0x1F21A),
    (0x1F22F, 0x1F22F), (0x1F232, 0x1F23A), (0x1F23C, 0x1F23F),
    (0x1F249, 0x1F3FA), (0x1F400, 0x1F53D), (0x1F546, 0x1F64F),
    (0x1F680, 0x1F6FF), (0x1F774, 0x1F77F), (0x1F7D5, 0x1F7FF),
    (0x1F80C, 0x1F80F), (0x1F848, 0x1F84F), (0x1F85A, 0x1F85F),
    (0x1F888, 0x1F88F), (0x1F8AE, 0x1F8FF), (0x1F90C, 0x1F93A),
    (0x1F93C, 0x1F945), (0x1F947, 0x1FAFF), (0x1FC00, 0x1FFFD)])


def _in(ranges: Ranges, cp: int) -> bool:
    lo, hi = 0, len(ranges)
    while lo < hi:
        mid = (lo + hi) // 2
        if ranges[mid][1] < cp:
            lo = mid + 1
        else:
            hi = mid
    return lo < len(ranges) and ranges[lo][0] <= cp


@functools.lru_cache(maxsize=4096)
def _gcb(c: str) -> str:
    """The Grapheme_Cluster_Break class of ``c``, from ``unicodedata``
    and the short lists above."""
    cp = ord(c)
    if c == "\r":
        return "CR"
    if c == "\n":
        return "LF"
    if cp == 0x200D:
        return "ZWJ"
    if 0x1F1E6 <= cp <= 0x1F1FF:
        return "RI"
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return "L"
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return "V"
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return "T"
    if 0xAC00 <= cp <= 0xD7A3:
        return "LV" if (cp - 0xAC00) % 28 == 0 else "LVT"
    if _in(_PREPEND, cp):
        return "Prepend"
    cat = unicodedata.category(c)
    if cat in ("Mn", "Me") or _in(_EXTEND_EXTRA, cp):
        return "Extend"
    if cat in ("Cc", "Cf", "Zl", "Zp", "Cs"):
        return "Control"
    if cat == "Mc" or cp in (0xE33, 0xEB3):
        return "Other" if _in(_MC_OTHER, cp) else "SpacingMark"
    if _in(_EXT_PICT, cp):
        return "ExtPict"
    return "Other"


def graphemes(text: str) -> List[str]:
    """``text`` cut into extended grapheme clusters by UAX #29's rules
    GB3-GB13 (GB9c, the Indic conjunct rule, is not taken)."""
    if not text:
        return []
    out, start = [], 0
    prev = _gcb(text[0])
    ri_run = 1 if prev == "RI" else 0
    pict_zwj = False          # ExtPict Extend* ZWJ ends at the previous char
    pict_seq = prev == "ExtPict"
    for i in range(1, len(text)):
        cur = _gcb(text[i])
        if prev == "CR" and cur == "LF":
            brk = False
        elif prev in ("Control", "CR", "LF") or cur in ("Control", "CR", "LF"):
            brk = True
        elif prev == "L" and cur in ("L", "V", "LV", "LVT"):
            brk = False
        elif prev in ("LV", "V") and cur in ("V", "T"):
            brk = False
        elif prev in ("LVT", "T") and cur == "T":
            brk = False
        elif cur in ("Extend", "ZWJ", "SpacingMark") or prev == "Prepend":
            brk = False
        elif prev == "ZWJ" and cur == "ExtPict" and pict_zwj:
            brk = False
        elif prev == "RI" and cur == "RI":
            brk = ri_run % 2 == 0
        else:
            brk = True
        if brk:
            out.append(text[start:i])
            start = i
        pict_zwj = pict_seq and cur == "ZWJ"
        if cur == "ExtPict":
            pict_seq = True
        elif not (pict_seq and cur == "Extend"):
            pict_seq = False
        ri_run = ri_run + 1 if cur == "RI" else 0
        prev = cur
    out.append(text[start:])
    return out


# -- pre-tokenizers --------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable character table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@functools.lru_cache(maxsize=1)
def byte_level_split() -> "re.Pattern":
    """The GPT-2 split pattern of the ByteLevel pre-tokenizer,
    ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``,
    through :func:`onig_regex`."""
    return onig_regex(r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
                      r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")


class PreTokenizer:
    """Pieces in, pieces out; ``reads_offsets``: a Metaspace "first"
    inside."""

    reads_offsets = False

    def __call__(self, pieces: List[Piece]) -> List[Piece]:
        raise NotImplementedError


class _NoPre(PreTokenizer):
    def __call__(self, pieces):
        return pieces


class _SequencePre(PreTokenizer):
    def __init__(self, parts):
        self.parts = parts
        self.reads_offsets = any(p.reads_offsets for p in parts)

    def __call__(self, pieces):
        for part in self.parts:
            pieces = part(pieces)
        return pieces


class _ByteLevelPre(PreTokenizer):
    def __init__(self, spec):
        self.add_prefix_space = bool(spec.get("add_prefix_space", False))
        self.use_regex = bool(spec.get("use_regex", True))
        self.byte_map = bytes_to_unicode()
        self._maps = [self.byte_map[b] for b in range(256)]

    def __call__(self, pieces):
        out = []
        for text, starts in pieces:
            if self.add_prefix_space and not text.startswith(" "):
                text = " " + text
                if starts is not None:
                    starts = starts[:1] + starts
            if self.use_regex:
                spans = [(s, e) for s, e, _ in
                         find_matches(byte_level_split(), text)]
                out += _cut((text, starts), spans)
            elif text:
                out.append((text, starts))
        maps = self._maps
        mapped = []
        for text, starts in out:
            raw = text.encode("utf-8")
            word = "".join([maps[b] for b in raw])
            if starts is not None:
                starts = [s for c, s in zip(text, starts)
                          for _ in range(len(c.encode("utf-8")))]
            mapped.append((word, starts))
        return mapped


class _SplitPre(PreTokenizer):
    def __init__(self, matcher, behavior):
        self.matcher = matcher
        self.behavior = behavior

    def __call__(self, pieces):
        out = []
        for piece in pieces:
            out += _cut(piece, split_spans(self.matcher(piece[0]),
                                           self.behavior))
        return out


def _invert(matcher):
    return lambda text: [(s, e, not m) for s, e, m in matcher(text)]


#: the package's punctuation table is Unicode 9.0's (the
#: ``unicode_categories`` crate): the ``P*`` characters assigned since,
#: and two whose category changed from ``Po`` since
_PUNCT_SINCE_9 = [
    (0x61D, 0x61D), (0x9FD, 0x9FD), (0xA76, 0xA76), (0xC77, 0xC77),
    (0xC84, 0xC84), (0x1B7D, 0x1B7E), (0x2E43, 0x2E4F), (0x2E52, 0x2E5D),
    (0x10EAD, 0x10EAD), (0x10F55, 0x10F59), (0x10F86, 0x10F89),
    (0x1144B, 0x1144F), (0x1145A, 0x1145B), (0x1145D, 0x1145D),
    (0x11660, 0x1166C), (0x116B9, 0x116B9), (0x1183B, 0x1183B),
    (0x11944, 0x11946), (0x119E2, 0x119E2), (0x11A3F, 0x11A46),
    (0x11A9A, 0x11A9C), (0x11A9E, 0x11AA2), (0x11B00, 0x11B09),
    (0x11C41, 0x11C45), (0x11C70, 0x11C71), (0x11EF7, 0x11EF8),
    (0x11F43, 0x11F4F), (0x11FFF, 0x11FFF), (0x12FF1, 0x12FF2),
    (0x16E97, 0x16E9A), (0x16FE2, 0x16FE2), (0x1E95E, 0x1E95F)]
_PUNCT_BEFORE_9 = frozenset((0x166D, 0x111C9))


def _is_punctuation(c: str) -> bool:
    """Rust's ``is_ascii_punctuation`` or a Unicode ``P*`` category of
    the package's Unicode 9.0 table."""
    if c.isascii():
        return c in "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"
    cp = ord(c)
    if cp in _PUNCT_BEFORE_9:
        return True
    return unicodedata.category(c)[0] == "P" and not _in(_PUNCT_SINCE_9, cp)


def _is_numeric(c: str) -> bool:
    """Rust's ``char::is_numeric``: the Nd, Nl and No categories."""
    return unicodedata.category(c) in ("Nd", "Nl", "No")


#: the Whitespace pre-tokenizer's ``\\w`` (the ``regex`` crate's:
#: Alphabetic, marks, Nd, Pc, Join_Control); Other_Alphabetic adds the
#: circled and squared letters beyond marks
_RUST_WORD_EXTRA = [(0x200C, 0x200D), (0x24B6, 0x24E9), (0x1F130, 0x1F149),
                    (0x1F150, 0x1F169), (0x1F170, 0x1F189)]


@functools.lru_cache(maxsize=1)
def _whitespace_regex() -> "re.Pattern":
    word = class_body(_union(_cats("L", "M", "Nd", "Nl", "Pc"),
                             _RUST_WORD_EXTRA))
    not_word_space = class_body(_complement(_union(
        _cats("L", "M", "Nd", "Nl", "Pc"), _RUST_WORD_EXTRA, _white_space())))
    return re.compile(f"{word}+|{not_word_space}+")


class _MetaspacePre(PreTokenizer):
    def __init__(self, spec):
        self.replacement, self.scheme, self.split = metaspace(spec)
        self.reads_offsets = self.scheme == "first"

    def __call__(self, pieces):
        rep = self.replacement
        out = []
        for text, starts in pieces:
            text = text.replace(" ", rep)
            if not text.startswith(rep) and (
                    self.scheme == "always"
                    or (self.scheme == "first" and starts is not None
                        and starts[0] == 0)):
                text = rep + text
                if starts is not None:
                    starts = starts[:1] + starts
            if self.split:
                spans = split_spans(char_matches(lambda c: c == rep, text),
                                    "merged_with_next")
                out += _cut((text, starts), spans)
            elif text:
                out.append((text, starts))
        return out


def metaspace(spec: Dict) -> Tuple[str, str, bool]:
    """(replacement, prepend scheme, split) of a Metaspace pre-tokenizer
    or decoder: ``"always"``, ``"never"`` or ``"first"`` (prepend only to
    the piece that starts the original text, not to one after an added
    token); the legacy ``add_prefix_space`` reads as "always" / "never"."""
    scheme = spec.get("prepend_scheme") or (
        "always" if spec.get("add_prefix_space", True) else "never")
    if scheme not in ("always", "never", "first"):
        raise not_ported(f"Metaspace prepend_scheme {scheme!r}")
    rep = spec.get("replacement", "▁")
    if len(rep) != 1:
        raise not_ported(f"Metaspace replacement {rep!r}")
    return rep, scheme, bool(spec.get("split", True))


def pre_tokenizer(spec: Optional[Dict]) -> PreTokenizer:
    """A ``tokenizer.json`` pre-tokenizer; anything not listed in this
    module's docstring raises ``NotImplementedError``."""
    if spec is None:
        return _NoPre()
    kind = spec.get("type")
    if kind == "Sequence":
        return _SequencePre([pre_tokenizer(s) for s in
                             spec.get("pretokenizers") or []])
    if kind == "ByteLevel":
        return _ByteLevelPre(spec)
    if kind == "Split":
        matcher = functools.partial(find_matches, _pattern(spec["pattern"]))
        if spec.get("invert"):
            matcher = _invert(matcher)
        return _SplitPre(matcher, _behavior(spec.get("behavior")))
    if kind == "Punctuation":
        return _SplitPre(functools.partial(char_matches, _is_punctuation),
                         _behavior(spec.get("behavior", "isolated")))
    if kind == "Digits":
        return _SplitPre(functools.partial(char_matches, _is_numeric),
                         "isolated" if spec.get("individual_digits")
                         else "contiguous")
    if kind == "WhitespaceSplit":
        return _SplitPre(functools.partial(
            char_matches, _WS_SET.__contains__), "removed")
    if kind == "Whitespace":
        return _SplitPre(_invert(lambda text: find_matches(
            _whitespace_regex(), text)), "removed")
    if kind == "Metaspace":
        return _MetaspacePre(spec)
    raise not_ported(f"pre-tokenizer {kind!r}")


# -- decoders ------------------------------------------------------------------------

Decoder = Callable[[List[str]], List[str]]


@functools.lru_cache(maxsize=1)
def _char_bytes() -> Dict[str, int]:
    return {c: b for b, c in bytes_to_unicode().items()}


def _byte_level_decode(tokens: List[str]) -> List[str]:
    char_bytes = _char_bytes()
    raw = bytearray()
    for tok in tokens:
        try:
            raw += bytes(char_bytes[c] for c in tok)
        except KeyError:      # a token outside the byte alphabet
            raw += tok.encode("utf-8")
    return [raw.decode("utf-8", errors="replace")]


def _metaspace_decode(spec) -> Decoder:
    rep, scheme, _ = metaspace(spec)

    def dec(tokens):
        return [tok.replace(rep, "" if i == 0 and scheme != "never" else " ")
                for i, tok in enumerate(tokens)]
    return dec


def _replace_decode(spec) -> Decoder:
    literal = spec["pattern"].get("String")
    regex = _pattern(spec["pattern"])
    content = spec["content"]
    if literal:
        return lambda tokens: [t.replace(literal, content) for t in tokens]
    return lambda tokens: ["".join(content if m else t[s:e]
                                   for s, e, m in find_matches(regex, t))
                           for t in tokens]


_BYTE_TOKEN = re.compile(rb"<0x(\+[0-9A-Fa-f]|[0-9A-Fa-f]{2})>")


def _byte_fallback_decode(tokens: List[str]) -> List[str]:
    """``<0xXX>`` runs to text: a run that is valid UTF-8 decodes, an
    invalid one gives one U+FFFD per byte."""
    out: List[str] = []
    run = bytearray()

    def flush():
        if run:
            try:
                out.append(run.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" * len(run))
            run.clear()

    for tok in tokens:
        m = _BYTE_TOKEN.fullmatch(tok.encode("utf-8"))
        if m is not None:
            run.append(int(m.group(1), 16))
            continue
        flush()
        out.append(tok)
    flush()
    return out


def _strip_decode(spec) -> Decoder:
    content = spec["content"]
    start, stop = int(spec.get("start", 0)), int(spec.get("stop", 0))

    def dec(tokens):
        out = []
        for tok in tokens:
            a = 0
            for i, c in enumerate(tok[:start]):
                if c != content:
                    break
                a = i + 1
            b = len(tok)
            for i in range(min(stop, len(tok))):
                if tok[len(tok) - i - 1] != content:
                    break
                b = len(tok) - i - 1
            out.append(tok[a:max(a, b)])
        return out
    return dec


def decoder(spec: Optional[Dict]) -> Callable[[List[str]], str]:
    """A ``tokenizer.json`` decoder as tokens -> text (no decoder joins the
    tokens with spaces); anything not listed in this module's docstring
    raises ``NotImplementedError``."""
    if spec is None:
        return " ".join
    chain = _decode_chain(spec)
    return lambda tokens: "".join(chain(list(tokens)))


def _decode_chain(spec: Dict) -> Decoder:
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [_decode_chain(s) for s in spec.get("decoders") or []]

        def seq(tokens):
            for part in parts:
                tokens = part(tokens)
            return tokens
        return seq
    if kind == "ByteLevel":
        return _byte_level_decode
    if kind == "Metaspace":
        return _metaspace_decode(spec)
    if kind == "Replace":
        return _replace_decode(spec)
    if kind == "ByteFallback":
        return _byte_fallback_decode
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        return _strip_decode(spec)
    raise not_ported(f"decoder {kind!r}")


# -- post-processors -------------------------------------------------------------

def template_ids(spec: Dict) -> List[Optional[int]]:
    """A ``TemplateProcessing`` single template as ids, None for the
    sequence."""
    specials = spec.get("special_tokens") or {}
    out: List[Optional[int]] = []
    for item in spec["single"]:
        if "Sequence" in item:
            if item["Sequence"].get("id", "A") != "A":
                raise not_ported("a single template over sequence B")
            out.append(None)
        else:
            out += specials[item["SpecialToken"]["id"]]["ids"]
    return out


def post_processor(spec: Optional[Dict]) -> Callable[[List[int]], List[int]]:
    """A ``tokenizer.json`` post-processor on one sequence's ids."""
    if spec is None or spec.get("type") == "ByteLevel":
        return lambda ids: ids
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [post_processor(s) for s in spec.get("processors") or []]

        def seq(ids):
            for part in parts:
                ids = part(ids)
            return ids
        return seq
    if kind == "TemplateProcessing":
        template = template_ids(spec)

        def apply(ids):
            out: List[int] = []
            for item in template:
                out += ids if item is None else [item]
            return out
        return apply
    raise not_ported(f"post_processor {kind!r}")
