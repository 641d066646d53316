"""SentencePiece model files (``tokenizer.model``, ``spiece.model``) read
and written without ``protobuf`` or ``sentencepiece``.

A model file is a serialized ``ModelProto`` (sentencepiece_model.proto).
:func:`parse_model_proto` decodes its wire format itself and keeps the
fields that decide encoding: the pieces (piece, score, type), the trainer
spec's ``model_type``, ``byte_fallback``, special ids and pieces and its
splitting options, and the normalizer spec's ``name``,
``precompiled_charsmap``, ``add_dummy_prefix``,
``remove_extra_whitespaces`` and ``escape_whitespaces`` (every other field
is skipped).  :func:`serialize_model_proto` writes such a file.

:func:`unigram_spec` and :func:`bpe_spec` turn a proto into the
``tokenizer.json`` spec the port's readers take, as ``transformers``'
``convert_slow_tokenizer`` builds it: ``T5Converter`` for a Unigram model
(the pieces' scores, the ``Precompiled`` charsmap, right strip and folded
space runs, a ``Metaspace`` pre-tokenizer and decoder, ``</s>``
appended), ``LlamaConverter`` for a BPE model (merges ordered by the
merged piece's score, as ``generate_merges`` orders them, byte fallback,
``Prepend``/``Replace`` normalizers, the byte-fallback decoder).  For a
snapshot that ships only a model file, ``AutoTokenizer(use_fast=True)``
runs exactly these conversions.  A field whose value the conversion does
not model (it would change the ids) raises ``NotImplementedError``
naming ROADMAP.md's "Snapshot tokenizers" item (:func:`check_supported`).
The training-only options (``split_digits``, ``split_by_unicode_script``,
``split_by_number``) shape which pieces exist, not how text is encoded,
so they are read and accepted.
"""

from __future__ import annotations

import base64
import dataclasses
import struct
from typing import Dict, Iterator, List, Optional, Tuple

from .tokenizer_parts import not_ported

#: ``TrainerSpec.model_type``
UNIGRAM, BPE, WORD, CHAR = 1, 2, 3, 4
MODEL_TYPES = {UNIGRAM: "UNIGRAM", BPE: "BPE", WORD: "WORD", CHAR: "CHAR"}
#: ``SentencePiece.type``
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5

#: field number -> (name, kind, default) of the fields read
TRAINER_FIELDS = {
    3: ("model_type", "int32", UNIGRAM),
    21: ("split_by_unicode_script", "bool", True),
    22: ("split_by_whitespace", "bool", True),
    23: ("split_by_number", "bool", True),
    24: ("treat_whitespace_as_suffix", "bool", False),
    25: ("split_digits", "bool", False),
    35: ("byte_fallback", "bool", False),
    40: ("unk_id", "int32", 0),
    41: ("bos_id", "int32", 1),
    42: ("eos_id", "int32", 2),
    43: ("pad_id", "int32", -1),
    45: ("unk_piece", "string", "<unk>"),
    46: ("bos_piece", "string", "<s>"),
    47: ("eos_piece", "string", "</s>"),
    48: ("pad_piece", "string", "<pad>"),
}
NORMALIZER_FIELDS = {
    1: ("name", "string", ""),
    2: ("precompiled_charsmap", "bytes", b""),
    3: ("add_dummy_prefix", "bool", True),
    4: ("remove_extra_whitespaces", "bool", True),
    5: ("escape_whitespaces", "bool", True),
}
_WIRE = {"int32": _VARINT, "bool": _VARINT, "string": _LEN, "bytes": _LEN,
         "float": _I32}


@dataclasses.dataclass
class ModelProto:
    """The fields of a ``ModelProto`` that decide encoding: ``pieces`` as
    (piece, score, type), the trainer and normalizer specs as dicts
    (every field of :data:`TRAINER_FIELDS` / :data:`NORMALIZER_FIELDS`,
    defaults filled), and the denormalizer spec (None when absent)."""

    pieces: List[Tuple[str, float, int]]
    trainer_spec: Dict
    normalizer_spec: Dict
    denormalizer_spec: Optional[Dict] = None


# -- the wire format ------------------------------------------------------------

def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("ModelProto: truncated varint")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7
        if shift >= 70:
            raise ValueError("ModelProto: varint longer than 10 bytes")


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of each field of a message: an int
    for a varint, bytes otherwise."""
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == _VARINT:
            value, pos = _varint(buf, pos)
        elif wire in (_I64, _I32):
            n = 8 if wire == _I64 else 4
            value, pos = buf[pos:pos + n], pos + n
        elif wire == _LEN:
            n, pos = _varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        else:
            raise ValueError(f"ModelProto: wire type {wire} (groups are not "
                             "part of sentencepiece_model.proto)")
        if pos > end:
            raise ValueError("ModelProto: truncated field")
        yield num, wire, value


def _value(kind: str, wire: int, raw, name: str):
    if wire != _WIRE[kind]:
        raise ValueError(f"ModelProto: field {name} has wire type {wire}")
    if kind == "int32":
        raw &= 0xFFFFFFFF
        return raw - (1 << 32) if raw >= 1 << 31 else raw
    if kind == "bool":
        return raw != 0
    if kind == "string":
        return bytes(raw).decode("utf-8")
    if kind == "float":
        return struct.unpack("<f", raw)[0]
    return bytes(raw)


def _message(buf: bytes, fields: Dict) -> Dict:
    out = {name: default for name, _, default in fields.values()}
    for num, wire, raw in _fields(buf):
        if num in fields:
            name, kind, _ = fields[num]
            out[name] = _value(kind, wire, raw, name)
    return out


def _piece(buf: bytes) -> Tuple[str, float, int]:
    got = _message(buf, {1: ("piece", "string", ""),
                         2: ("score", "float", 0.0),
                         3: ("type", "int32", NORMAL)})
    return got["piece"], got["score"], got["type"]


def parse_model_proto(data: bytes) -> ModelProto:
    """Decode a serialized ``ModelProto``."""
    pieces, trainer, normalizer, denormalizer = [], b"", b"", None
    for num, wire, raw in _fields(bytes(data)):
        if num in (1, 2, 3, 5) and wire != _LEN:
            raise ValueError(f"ModelProto: field {num} has wire type {wire}")
        if num == 1:
            pieces.append(_piece(raw))
        elif num == 2:
            trainer += raw          # a repeated message merges, as protobuf's
        elif num == 3:
            normalizer += raw
        elif num == 5:
            denormalizer = (denormalizer or b"") + raw
    return ModelProto(
        pieces=pieces, trainer_spec=_message(trainer, TRAINER_FIELDS),
        normalizer_spec=_message(normalizer, NORMALIZER_FIELDS),
        denormalizer_spec=(None if denormalizer is None
                           else _message(denormalizer, NORMALIZER_FIELDS)))


def read_model_proto(path: str) -> ModelProto:
    with open(path, "rb") as f:
        return parse_model_proto(f.read())


def _put_varint(value: int) -> bytes:
    value &= (1 << 64) - 1          # negative int32s take ten bytes
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _put(num: int, kind: str, value) -> bytes:
    key = _put_varint(num << 3 | _WIRE[kind])
    if kind in ("int32", "bool"):
        return key + _put_varint(int(value))
    if kind == "float":
        return key + struct.pack("<f", value)
    data = value.encode("utf-8") if kind == "string" else bytes(value)
    return key + _put_varint(len(data)) + data


def _put_message(values: Dict, fields: Dict) -> bytes:
    by_name = {name: (num, kind) for num, (name, kind, _) in fields.items()}
    unknown = set(values) - set(by_name)
    if unknown:
        raise ValueError(f"ModelProto: no field {sorted(unknown)}")
    return b"".join(_put(*by_name[name], values[name])
                    for name in sorted(values, key=lambda n: by_name[n][0]))


def serialize_model_proto(pieces, trainer_spec: Optional[Dict] = None,
                          normalizer_spec: Optional[Dict] = None) -> bytes:
    """A ``ModelProto`` as protobuf serializes it: each piece with its
    piece, score and type, then the trainer and normalizer specs with the
    fields given (in field-number order; a field left out keeps its
    default)."""
    out = bytearray()
    for piece, score, kind in pieces:
        body = (_put(1, "string", piece) + _put(2, "float", score)
                + _put(3, "int32", kind))
        out += _put(1, "bytes", body)
    if trainer_spec is not None:
        out += _put(2, "bytes", _put_message(trainer_spec, TRAINER_FIELDS))
    if normalizer_spec is not None:
        out += _put(3, "bytes", _put_message(normalizer_spec,
                                             NORMALIZER_FIELDS))
    return bytes(out)


# -- the conversions ------------------------------------------------------------

def check_supported(proto: ModelProto) -> None:
    """Raise ``NotImplementedError`` for a field whose value the port's
    conversion does not honour: a model type other than Unigram or BPE,
    whitespace as a suffix or unescaped, a denormalizer; for Unigram, byte
    fallback, pieces across whitespace (``split_by_whitespace`` off) or
    whitespace kept as is (``remove_extra_whitespaces`` off: the
    conversion strips and folds it); for BPE, a charsmap or extra
    whitespace removal (the conversion applies neither)."""
    trainer, norm = proto.trainer_spec, proto.normalizer_spec
    kind = trainer["model_type"]
    if kind not in (UNIGRAM, BPE):
        raise not_ported(f"a SentencePiece {MODEL_TYPES.get(kind, kind)} "
                         "model")
    if trainer["treat_whitespace_as_suffix"]:
        raise not_ported("SentencePiece treat_whitespace_as_suffix")
    if not norm["escape_whitespaces"]:
        raise not_ported("SentencePiece escape_whitespaces=false")
    if proto.denormalizer_spec is not None and \
            proto.denormalizer_spec["precompiled_charsmap"]:
        raise not_ported("a SentencePiece denormalizer charsmap")
    if kind == UNIGRAM:
        if trainer["byte_fallback"]:
            raise not_ported("SentencePiece Unigram byte_fallback")
        if not trainer["split_by_whitespace"]:
            raise not_ported("SentencePiece Unigram split_by_whitespace=false")
        if not norm["remove_extra_whitespaces"]:
            raise not_ported("SentencePiece Unigram "
                             "remove_extra_whitespaces=false")
    else:
        if norm["precompiled_charsmap"]:
            raise not_ported("a SentencePiece BPE model's precompiled_charsmap "
                             f"(normalizer {norm['name']!r})")
        if norm["remove_extra_whitespaces"]:
            raise not_ported("SentencePiece BPE remove_extra_whitespaces=true")


def _added_pieces(proto: ModelProto) -> List[Dict]:
    """Control pieces (special) and user-defined ones as added tokens
    matched before normalization, as ``SpmConverter.tokenizer`` adds
    them."""
    return [{"id": i, "content": piece, "single_word": False, "lstrip": False,
             "rstrip": False, "normalized": False, "special": kind == CONTROL}
            for i, (piece, _, kind) in enumerate(proto.pieces)
            if kind in (CONTROL, USER_DEFINED)]


def _prepend_scheme(add_prefix_space: bool, legacy: bool) -> str:
    """``convert_slow_tokenizer._get_prepend_scheme``."""
    if not add_prefix_space:
        return "never"
    return "always" if legacy else "first"


def unigram_spec(proto: ModelProto, extra_ids: int = 0,
                 legacy: bool = True) -> Dict:
    """``T5Converter``'s ``tokenizer.json`` spec: the pieces and their
    scores then ``extra_ids`` ``<extra_id_*>`` pieces (last first, score
    0), the unknown id, the charsmap (if any) with a right strip and
    space runs to ``"▁"``, ``Metaspace`` at the proto's
    ``add_dummy_prefix`` (``"first"`` when not ``legacy``), ``</s>``
    appended."""
    check_supported(proto)
    if proto.trainer_spec["model_type"] != UNIGRAM:
        raise ValueError("unigram_spec needs a Unigram model")
    vocab = [[piece, score] for piece, score, _ in proto.pieces]
    vocab += [[f"<extra_id_{i}>", 0.0] for i in range(extra_ids - 1, -1, -1)]
    eos = next((i for i, (p, _) in enumerate(vocab) if p == "</s>"), None)
    if eos is None:
        raise not_ported("a Unigram model without a '</s>' piece (the T5 "
                         "conversion appends it)")
    norms = []
    charsmap = proto.normalizer_spec["precompiled_charsmap"]
    if charsmap:
        norms.append({"type": "Precompiled", "precompiled_charsmap":
                      base64.b64encode(charsmap).decode("ascii")})
    norms += [{"type": "Strip", "strip_left": False, "strip_right": True},
              {"type": "Replace", "pattern": {"Regex": " {2,}"},
               "content": "▁"}]
    meta = {"type": "Metaspace", "replacement": "▁", "split": True,
            "prepend_scheme": _prepend_scheme(
                proto.normalizer_spec["add_dummy_prefix"], legacy)}
    return {
        "added_tokens": _added_pieces(proto),
        "normalizer": {"type": "Sequence", "normalizers": norms},
        "pre_tokenizer": meta, "decoder": meta,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "special_tokens": {"</s>": {"id": "</s>", "ids": [eos],
                                        "tokens": ["</s>"]}}},
        "model": {"type": "Unigram", "unk_id": proto.trainer_spec["unk_id"],
                  "vocab": vocab, "byte_fallback": False},
    }


def merges_by_score(vocab: Dict[str, int],
                    vocab_scores: List[Tuple[str, float]]) -> List[List[str]]:
    """``convert_slow_tokenizer.generate_merges`` with scores: every split
    of every piece into two pieces of ``vocab`` (by the halves' ids), all
    ordered by the merged piece's score, then the longer left half, then
    the longer right half, highest first (a stable sort)."""
    merges = []
    for merge, score in dict(vocab_scores).items():
        local = [(merge[:i], merge[i:], score) for i in range(1, len(merge))
                 if merge[:i] in vocab and merge[i:] in vocab]
        local.sort(key=lambda m: (vocab[m[0]], vocab[m[1]]))
        merges += local
    merges.sort(key=lambda m: (m[2], len(m[0]), len(m[1])), reverse=True)
    return [[a, b] for a, b, _ in merges]


def bpe_spec(proto: ModelProto, legacy: bool = True) -> Dict:
    """``LlamaConverter``'s ``tokenizer.json`` spec: the pieces as the BPE
    vocabulary (the first three scored 0), merges by score
    (:func:`merges_by_score` over the proto's pieces), the trainer's
    unknown piece, fused unknowns, byte fallback; legacy normalizers (a
    ``"▁"`` prepended when the proto's ``add_dummy_prefix``, spaces to
    ``"▁"``) or, not ``legacy``, a ``Metaspace`` pre-tokenizer without
    splitting; the byte-fallback decoder, stripping the prefix space when
    one was added.  The BOS/EOS template is the tokenizer class's
    (``tokenizer._llama_template``)."""
    check_supported(proto)
    if proto.trainer_spec["model_type"] != BPE:
        raise ValueError("bpe_spec needs a BPE model")
    scores = [(piece, 0.0 if i < 3 else score)
              for i, (piece, score, _) in enumerate(proto.pieces)]
    listed = {piece: i for i, (piece, _, _) in enumerate(proto.pieces)}
    prefix = proto.normalizer_spec["add_dummy_prefix"]
    if legacy:
        norms = [{"type": "Prepend", "prepend": "▁"}] if prefix else []
        norms.append({"type": "Replace", "pattern": {"String": " "},
                      "content": "▁"})
        normalizer, pre = {"type": "Sequence", "normalizers": norms}, None
    else:
        normalizer = None
        pre = {"type": "Metaspace", "replacement": "▁", "split": False,
               "prepend_scheme": _prepend_scheme(prefix, legacy)}
    decoders = [{"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
                {"type": "ByteFallback"}, {"type": "Fuse"}]
    if prefix:
        decoders.append({"type": "Strip", "content": " ", "start": 1,
                         "stop": 0})
    return {
        "added_tokens": _added_pieces(proto),
        "normalizer": normalizer, "pre_tokenizer": pre,
        "post_processor": None,
        "decoder": {"type": "Sequence", "decoders": decoders},
        "model": {"type": "BPE", "dropout": None,
                  "unk_token": proto.trainer_spec["unk_piece"],
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": True,
                  "byte_fallback": True, "ignore_merges": False,
                  "vocab": {piece: i for i, (piece, _) in enumerate(scores)},
                  "merges": merges_by_score(listed, scores)},
    }
