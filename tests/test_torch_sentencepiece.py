"""SentencePiece model files on the port (``utils/sentencepiece_model.py``
and ``utils.tokenizer.load_tokenizer``) against ``protobuf`` and
``transformers``' conversions, which need no ``sentencepiece``.

Small ``ModelProto`` files are built here with
``transformers.utils.sentencepiece_model_pb2_new``.  The port's reader
must give the fields protobuf parses, and its writer the bytes protobuf
serializes.  A Unigram snapshot must encode and decode as
``T5Converter(...).converted()`` wrapped in ``T5TokenizerFast``; a BPE one
with byte fallback as ``LlamaConverter``, whose ``SentencePieceExtractor``
(it needs the library only to list the pieces) is replaced by a stub that
lists them from the proto, wrapped in ``LlamaTokenizerFast``.  Ids and
decodes are compared exactly.
"""

import csv
import functools
import importlib
import json
import math
import os
import re
from collections import Counter

import pytest

from llm_interpretation_replication_tpu_torch.config import (
    legal_scenarios, ordinary_meaning_questions)
from llm_interpretation_replication_tpu_torch.utils import (
    sentencepiece_model as spm)
from llm_interpretation_replication_tpu_torch.utils import tokenizer as ttok
import chip_smoke
from test_torch_slots import one_torch_thread  # noqa: F401

pb = pytest.importorskip("transformers.utils.sentencepiece_model_pb2_new")

ASCII = ["Is a screenshot  a photograph?", "Yes", " No", "", " ", "x  \n\n y   ",
         "don't I'D we've 're 42 3.14 1,000", "  two leading", "trailing  ",
         "Answer: Yes Answer:No"]
MIXED = list(chip_smoke.TOKENIZER_EDGE_TEXTS) + [
    "bell\x07 nul\x00 esc\x1b del\x7f", "日本語のテキスト、かな。", "Ελληνικά ωραία",
    "emoji 🤖🧪 and marks é ạ̈", "zero​width line"]


def learn_texts():
    return ([s["original_main"] for s in legal_scenarios()]
            + ordinary_meaning_questions()[:60])


def all_texts():
    return ASCII + ordinary_meaning_questions() + MIXED


# -- building protos with protobuf ------------------------------------------------

def make_proto(pieces, trainer=None, normalizer=None):
    m = pb.ModelProto()
    for piece, score, kind in pieces:
        p = m.pieces.add()
        p.piece, p.score, p.type = piece, score, kind
    for key, value in (trainer or {}).items():
        setattr(m.trainer_spec, key, value)
    for key, value in (normalizer or {}).items():
        setattr(m.normalizer_spec, key, value)
    return m


def unigram_pieces(texts, charsmap=None):
    normalize = (spm_normalizer(charsmap) if charsmap else (lambda t: t))
    words, chars = Counter(), Counter()
    for text in map(normalize, texts):
        for w in text.split():
            words["▁" + w] += 1
            chars.update(w)
    total = sum(words.values()) + sum(chars.values()) + 1
    out = [("<pad>", 0.0, spm.CONTROL), ("</s>", 0.0, spm.CONTROL),
           ("<unk>", 0.0, spm.UNKNOWN), ("▁", math.log(1 / total), spm.NORMAL),
           ("<mask>", 0.0, spm.USER_DEFINED)]
    out += [(w, math.log(c / total), spm.NORMAL)
            for w, c in sorted(words.items())]
    out += [(ch, math.log(c / total) - 5.0, spm.NORMAL)
            for ch, c in sorted(chars.items())]
    return out


def spm_normalizer(charsmap):
    from llm_interpretation_replication_tpu_torch.utils import tokenizer_parts

    return tokenizer_parts.Precompiled(chip_smoke._charsmap(charsmap))


def bpe_pieces(texts, dummy_prefix=True):
    words = Counter()
    for t in texts:
        t = t.replace(" ", "▁")
        words.update(re.findall("▁?[^▁]+|▁", "▁" + t if dummy_prefix else t))
    out = [("<unk>", 0.0, spm.UNKNOWN), ("<s>", 0.0, spm.CONTROL),
           ("</s>", 0.0, spm.CONTROL), ("<sep>", 0.0, spm.USER_DEFINED)]
    out += [(f"<0x{b:02X}>", 0.0, spm.BYTE) for b in range(256)]
    seen = {p for p, _, _ in out}
    merged = [a + b for a, b in chip_smoke._bpe_merges(words)]
    for piece in merged + sorted({c for w in words for c in w}):
        if piece not in seen:
            seen.add(piece)
            out.append((piece, -float(len(out)), spm.NORMAL))
    out.append(("▁unusedpiece", -1e9, spm.UNUSED))
    return out


# -- transformers' conversions as oracles -----------------------------------------

class _Slow:
    """What the converters read of a slow tokenizer."""

    def __init__(self, path, proto, **attrs):
        self.vocab_file = path
        self._pieces = [p.piece for p in proto.pieces]
        self.__dict__.update(attrs)

    def convert_ids_to_tokens(self, i):
        return self._pieces[i]

    def convert_tokens_to_ids(self, token):
        return self._pieces.index(token)


@functools.lru_cache(maxsize=None)
def llama_converter():
    """``LlamaConverter`` whose extractor lists the pieces from the proto
    (the extractor's vocabulary is ``sp.id_to_piece`` over the pieces) and
    orders the merges with ``generate_merges``, as the real one does."""
    csl = importlib.import_module("transformers.convert_slow_tokenizer")

    class Extractor:
        def __init__(self, model_file):
            m = pb.ModelProto()
            with open(model_file, "rb") as f:
                m.ParseFromString(f.read())
            self.pieces = [p.piece for p in m.pieces]

        def extract(self, vocab_scores=None):
            vocab = {p: i for i, p in enumerate(self.pieces)}
            return vocab, csl.generate_merges(vocab, vocab_scores)

    class Converter(csl.LlamaConverter):
        SpmExtractor = Extractor

    return Converter


def converter_oracle(path):
    """The fast tokenizer ``transformers`` makes of the snapshot's model
    file: the conversion, wrapped as ``T5TokenizerFast`` or
    ``LlamaTokenizerFast`` with the config's specials and flags, then the
    reference loader's pad rule."""
    from transformers import LlamaTokenizerFast, T5TokenizerFast

    csl = importlib.import_module("transformers.convert_slow_tokenizer")
    name = next(n for n in ("tokenizer.model", "spiece.model")
                if os.path.exists(os.path.join(path, n)))
    model_file = os.path.join(path, name)
    proto = pb.ModelProto()
    with open(model_file, "rb") as f:
        proto.ParseFromString(f.read())
    config, special = {}, {}
    for fname in ("tokenizer_config.json", "special_tokens_map.json"):
        if os.path.exists(os.path.join(path, fname)):
            with open(os.path.join(path, fname)) as f:
                conf = json.load(f)
            config = config or conf
            special.update({k: conf[k] for k in ("bos_token", "eos_token",
                                                 "unk_token", "pad_token")
                            if conf.get(k) is not None})
    legacy = config.get("legacy")
    legacy = True if legacy is None else legacy
    prefix = proto.normalizer_spec.add_dummy_prefix
    if proto.trainer_spec.model_type == 1:
        extra = config.get("extra_ids", 100)
        slow = _Slow(model_file, proto, _extra_ids=extra,
                     add_prefix_space=prefix, legacy=legacy)
        conv = csl.T5Converter(slow).converted()
        special = {"eos_token": "</s>", "unk_token": "<unk>",
                   "pad_token": "<pad>", **special}
        tok = T5TokenizerFast(tokenizer_object=conv, extra_ids=extra, **special)
    else:
        slow = _Slow(model_file, proto, add_prefix_space=prefix, legacy=legacy)
        conv = llama_converter()(slow).converted()
        special = {"bos_token": "<s>", "eos_token": "</s>",
                   "unk_token": "<unk>", **special}
        tok = LlamaTokenizerFast(
            tokenizer_object=conv, legacy=legacy,
            add_bos_token=config.get("add_bos_token", True),
            add_eos_token=config.get("add_eos_token", False), **special)
    if tok.pad_token_id is None:
        tok.pad_token = tok.eos_token
    return tok, conv


def write_snapshot(path, proto, name="spiece.model", config=None,
                   model_type=None):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, name), "wb") as f:
        f.write(proto.SerializeToString())
    if config is not None:
        with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
            json.dump(config, f)
    if model_type is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump({"model_type": model_type}, f)
    return str(path)


def assert_same(got, oracle, texts, raw=None):
    for text in texts:
        ids = got.encode(text)
        assert ids == oracle(text).input_ids, repr(text)
        assert got.encode(text, False) == oracle(
            text, add_special_tokens=False).input_ids, repr(text)
        if raw is not None and "<" not in text:
            assert got.encode(text, False) == raw.encode(
                text, add_special_tokens=False).ids, repr(text)
        for skip in (True, False):
            assert got.decode(ids, skip) == oracle.decode(
                ids, skip_special_tokens=skip), repr(text)
    assert (got.pad_token_id, got.eos_token_id) == (oracle.pad_token_id,
                                                    oracle.eos_token_id)


# -- the reader and the writer against protobuf -----------------------------------

def proto_fields(m):
    return dict(
        pieces=[(p.piece, p.score, p.type) for p in m.pieces],
        trainer={name: getattr(m.trainer_spec, name)
                 for name, _, _ in spm.TRAINER_FIELDS.values()},
        normalizer={name: getattr(m.normalizer_spec, name)
                    for name, _, _ in spm.NORMALIZER_FIELDS.values()},
        denormalizer=({name: getattr(m.denormalizer_spec, name)
                       for name, _, _ in spm.NORMALIZER_FIELDS.values()}
                      if m.HasField("denormalizer_spec") else None))


def port_fields(p):
    return dict(pieces=p.pieces, trainer=p.trainer_spec,
                normalizer=p.normalizer_spec, denormalizer=p.denormalizer_spec)


@pytest.mark.parametrize("case", ["defaults", "set", "extras"])
def test_reader_matches_protobuf(case):
    """Every field the reader keeps equals protobuf's parse of the same
    bytes: defaults filled, negative ids (ten-byte varints), float32
    scores, unicode pieces, and fields the reader skips (``vocab_size``,
    ``input``, ``self_test_data``, a denormalizer spec)."""
    pieces = [("<unk>", 0.0, 2), ("▁日本", -1.25, 1), ("é", -3.3333, 1),
              ("<0x0A>", 0.0, 6), ("<ctl>", 0.0, 3), ("u", -1e9, 5),
              ("🤖", -7.0, 4)]
    trainer = normalizer = None
    if case != "defaults":
        trainer = dict(model_type=2, byte_fallback=True, unk_id=5, bos_id=-1,
                       eos_id=7, pad_id=-1, unk_piece="<UNK>", bos_piece="[b]",
                       eos_piece="[e]", pad_piece="[p]", split_digits=True,
                       split_by_whitespace=False,
                       treat_whitespace_as_suffix=True,
                       split_by_unicode_script=False)
        normalizer = dict(name="nmt_nfkc", precompiled_charsmap=b"\x01\x00\xff",
                          add_dummy_prefix=False, remove_extra_whitespaces=False,
                          escape_whitespaces=False)
    m = make_proto(pieces, trainer, normalizer)
    if case == "extras":
        m.trainer_spec.vocab_size = 32000
        m.trainer_spec.input.extend(["a.txt", "b.txt"])
        m.trainer_spec.character_coverage = 0.9995
        m.normalizer_spec.normalization_rule_tsv = "x\ty"
        m.self_test_data.samples.add(input="in", expected="out")
        m.denormalizer_spec.name = "denorm"
        m.denormalizer_spec.add_dummy_prefix = False
    got = spm.parse_model_proto(m.SerializeToString())
    assert port_fields(got) == proto_fields(m)


def test_reader_rejects_malformed_bytes():
    with pytest.raises(ValueError, match="ModelProto"):
        spm.parse_model_proto(b"\x0a\x05\x0a\x01")      # truncated piece
    with pytest.raises(ValueError, match="wire type"):
        spm.parse_model_proto(b"\x0b")                  # a group start


@pytest.mark.parametrize("fmt", ["sp_unigram", "sp_bpe"])
def test_smoke_model_writer_matches_protobuf(fmt):
    """``chip_smoke.py``'s model files (the port's serializer; the card's
    machine may lack protobuf) are what protobuf writes: its parse gives
    the same fields, and serializing that parse gives the same bytes."""
    (name, blob), config, _ = chip_smoke._format_tokenizer_files(
        fmt, chip_smoke._tokenizer_learn_texts())
    assert name == {"sp_unigram": "spiece.model", "sp_bpe": "tokenizer.model"}[fmt]
    m = pb.ModelProto()
    m.ParseFromString(blob)
    assert m.SerializeToString() == blob
    assert port_fields(spm.parse_model_proto(blob)) == proto_fields(m)
    assert m.trainer_spec.model_type == (1 if fmt == "sp_unigram" else 2)
    if fmt == "sp_bpe":
        assert m.trainer_spec.byte_fallback and \
            not m.normalizer_spec.add_dummy_prefix
        assert config["tokenizer_class"] == "BaichuanTokenizer"


def test_writer_matches_protobuf_bytes():
    pieces = [("<unk>", 0.0, 2), ("▁a", -0.5, 1), ("<0xFF>", 0.0, 6)]
    trainer = dict(model_type=2, byte_fallback=True, pad_id=-1, unk_id=0,
                   unk_piece="<unk>", split_digits=True)
    normalizer = dict(name="identity", add_dummy_prefix=False,
                      precompiled_charsmap=b"\x00\x01")
    blob = spm.serialize_model_proto(pieces, trainer, normalizer)
    assert blob == make_proto(pieces, trainer, normalizer).SerializeToString()
    with pytest.raises(ValueError, match="no field"):
        spm.serialize_model_proto(pieces, dict(vocab_size=8))


def test_merges_by_score_match_generate_merges():
    csl = importlib.import_module("transformers.convert_slow_tokenizer")
    pieces = bpe_pieces(learn_texts())
    scores = [(p, 0.0 if i < 3 else s) for i, (p, s, _) in enumerate(pieces)]
    vocab = {p: i for i, (p, _, _) in enumerate(pieces)}
    assert spm.merges_by_score(vocab, scores) == [
        list(m) for m in csl.generate_merges(vocab, scores)]


# -- Unigram against T5Converter -------------------------------------------------

@pytest.mark.parametrize("charsmap,dummy_prefix,extra_ids", [
    (None, True, 0), ("t5", True, 100), ("t5", False, 3)])
def test_unigram_model_matches_t5_converter(tmp_path, charsmap, dummy_prefix,
                                            extra_ids):
    """A ``spiece.model``-only snapshot: ids (with and without ``</s>``)
    and decodes (skipping specials or not) equal to ``T5Converter``'s
    conversion in ``T5TokenizerFast`` on ASCII texts, the 100 questions
    and mixed Unicode (CJK, combining marks, emoji, controls); the raw
    conversion agrees where no special token is in the text."""
    cmap = chip_smoke.T5_CHARSMAP if charsmap else None
    normalizer = dict(name="nmt_nfkc" if cmap else "identity",
                      add_dummy_prefix=dummy_prefix)
    if cmap:
        normalizer["precompiled_charsmap"] = chip_smoke._charsmap(cmap)
    proto = make_proto(unigram_pieces(learn_texts(), cmap),
                       dict(model_type=1, unk_id=2, bos_id=-1, eos_id=1,
                            pad_id=0), normalizer)
    path = write_snapshot(tmp_path / "t5", proto, "spiece.model",
                          {"tokenizer_class": "T5Tokenizer",
                           "extra_ids": extra_ids}, "t5")
    got = ttok.load_tokenizer(path)
    assert isinstance(got, ttok.UnigramTokenizer)
    oracle, raw = converter_oracle(path)
    assert len(got) == len(oracle)
    assert_same(got, oracle, all_texts() + [f"<extra_id_{extra_ids - 1}>x"],
                raw)


# -- BPE with byte fallback against LlamaConverter --------------------------------

@pytest.mark.parametrize("dummy_prefix,legacy,add_bos,add_eos", [
    (True, None, True, False), (False, None, False, False),
    (True, False, True, True), (False, True, True, False)])
def test_bpe_model_matches_llama_converter(tmp_path, dummy_prefix, legacy,
                                           add_bos, add_eos):
    """A ``tokenizer.model`` with byte fallback (Baichuan2's kind): ids
    and decodes equal to ``LlamaConverter``'s conversion (stub extractor)
    in ``LlamaTokenizerFast`` with the config's BOS/EOS flags and
    ``legacy``; unknown characters go to ``<0xXX>`` bytes, control and
    user-defined pieces split out of the raw text."""
    proto = make_proto(
        bpe_pieces(learn_texts(), dummy_prefix),
        dict(model_type=2, byte_fallback=True, split_digits=True),
        dict(name="identity", add_dummy_prefix=dummy_prefix,
             remove_extra_whitespaces=False))
    config = {"tokenizer_class": "LlamaTokenizer", "add_bos_token": add_bos,
              "add_eos_token": add_eos}
    if legacy is not None:
        config["legacy"] = legacy
    path = write_snapshot(tmp_path / "llama", proto, "tokenizer.model", config,
                          "llama")
    got = ttok.load_tokenizer(path)
    assert isinstance(got, ttok.ByteLevelBPETokenizer) and got.byte_fallback
    oracle, raw = converter_oracle(path)
    assert_same(got, oracle, all_texts() + ["a<sep>b <s> c</s>"], raw)


# -- which file a snapshot's tokenizer comes from ---------------------------------

@pytest.mark.parametrize("model_type,with_json,reads", [
    ("baichuan", True, "model"), ("baichuan", False, "model"),
    ("llama", True, "json"), ("llama", False, "model"),
    (None, True, "json")])
def test_baichuan_reads_the_model_file_first(tmp_path, model_type, with_json,
                                             reads):
    """``config.json``'s ``model_type`` ``baichuan`` reads the
    SentencePiece file even beside a ``tokenizer.json`` (the reference's
    ``use_fast=False``); every other type takes the ``tokenizer.json``
    first and the model file without one."""
    texts = learn_texts()
    files = chip_smoke._format_tokenizer_files("sp_bpe", texts)
    path = str(tmp_path / "snap")
    os.makedirs(path)
    chip_smoke._write_tokenizer_files(path, files)
    if with_json:
        with open(os.path.join(path, "tokenizer.json"), "w") as f:
            json.dump(chip_smoke._bpe_tokenizer_files(texts)[0], f)
    if model_type:
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump({"model_type": model_type}, f)
    got = ttok.load_tokenizer(path)
    spm_only = str(tmp_path / "spm_only")
    os.makedirs(spm_only)
    chip_smoke._write_tokenizer_files(spm_only, files)
    want = ttok.load_tokenizer(spm_only)
    same = all(got.encode(t) == want.encode(t) for t in texts[:20])
    assert same == (reads == "model")
    if reads == "model":
        oracle, _ = converter_oracle(spm_only)
        assert_same(got, oracle, ASCII + MIXED[:8])


# -- what stays refused ------------------------------------------------------------

REFUSED = {
    "word_model": (dict(model_type=3), {}),
    "char_model": (dict(model_type=4), {}),
    "suffix_whitespace": (dict(model_type=2, treat_whitespace_as_suffix=True),
                          {}),
    "unescaped_whitespace": (dict(model_type=1),
                             dict(escape_whitespaces=False)),
    "unigram_byte_fallback": (dict(model_type=1, byte_fallback=True), {}),
    "unigram_no_whitespace_split": (dict(model_type=1,
                                         split_by_whitespace=False), {}),
    "unigram_whitespace_kept": (dict(model_type=1),
                                dict(remove_extra_whitespaces=False)),
    "bpe_charsmap": (dict(model_type=2), dict(
        precompiled_charsmap=chip_smoke._charsmap({"ﬁ": "fi"}),
        remove_extra_whitespaces=False)),
    "bpe_whitespace_removed": (dict(model_type=2), {}),
    "denormalizer": (dict(model_type=1), {}),
    "prefix_space_mismatch": (dict(model_type=2),
                              dict(remove_extra_whitespaces=False)),
    "bpe_under_t5_class": (dict(model_type=2),
                           dict(remove_extra_whitespaces=False)),
    "unigram_under_llama_class": (dict(model_type=1), {}),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_fields_name_the_roadmap_item(tmp_path, case):
    """Each field whose value the port's conversion does not honour (it
    would change the ids) raises ``NotImplementedError`` naming
    "Snapshot tokenizers"; nothing falls back to another reader."""
    trainer, normalizer = REFUSED[case]
    kind = trainer["model_type"]
    pieces = (unigram_pieces(ASCII) if kind == 1 else bpe_pieces(ASCII))
    proto = make_proto(pieces, trainer, normalizer)
    if case == "denormalizer":
        proto.denormalizer_spec.precompiled_charsmap = chip_smoke._charsmap(
            {"a": "b"})
    config = {"prefix_space_mismatch": {"add_prefix_space": False},
              "bpe_under_t5_class": {"tokenizer_class": "T5Tokenizer"},
              "unigram_under_llama_class": {"tokenizer_class":
                                            "LlamaTokenizer"}}.get(case)
    path = write_snapshot(tmp_path / case, proto, "tokenizer.model", config)
    with pytest.raises(NotImplementedError, match="Snapshot tokenizers"):
        ttok.load_tokenizer(path)


# -- run-instruct-sweep on a Baichuan2 snapshot with only its model file ----------

def test_run_instruct_sweep_reads_baichuans_model_file(tmp_path, capsys,
                                                       monkeypatch):
    """``run-instruct-sweep`` on a Baichuan snapshot that ships only a
    SentencePiece ``tokenizer.model`` (Baichuan2's layout, as
    ``chip_smoke.py`` writes it): the loader reads it through the
    ``ModelProto`` reader, every row is scored on the causal kernel's
    route, and the prompts' ids are the conversion's."""
    import test_torch_families as fam
    from test_torch_100q import QUESTIONS

    from llm_interpretation_replication_tpu_torch import __main__ as tcli
    from llm_interpretation_replication_tpu_torch import config as tconfig
    from llm_interpretation_replication_tpu_torch.scoring import prompts
    from llm_interpretation_replication_tpu_torch.sweeps import (
        instruct_sweep as tsweep)

    name = "tiny-org/baichuan-chat"
    questions = list(QUESTIONS)[:3]
    texts = [prompts.format_prompt(q, False, name) for q in questions] + [
        "Yes", "No", " Yes", " No"]
    snap = str(tmp_path / "snaps" / "tiny-org--baichuan-chat")
    os.makedirs(snap)
    kw = dict(fam.NEW_CASES["baichuan_7b"][1], vocab_size=4096)
    with open(os.path.join(snap, "config.json"), "w") as f:
        json.dump(kw, f)
    chip_smoke._write_safetensors(os.path.join(snap, "model.safetensors"),
                                  fam._remote_code_state_dict("baichuan_7b",
                                                              kw))
    chip_smoke._write_tokenizer_files(snap, chip_smoke._format_tokenizer_files(
        "sp_bpe", texts))
    assert "tokenizer.json" not in os.listdir(snap)
    tok = ttok.load_tokenizer(snap)
    oracle, _ = converter_oracle(snap)
    assert [tok.encode(t) for t in texts] == [oracle(t).input_ids
                                              for t in texts]
    monkeypatch.setattr(tsweep, "instruct_sweep_models", lambda: [name])
    monkeypatch.setattr(tconfig, "ordinary_meaning_questions",
                        lambda: questions)
    out = tmp_path / "out"
    tcli.main(["run-instruct-sweep", "--device", "cpu", "--dtype", "float32",
               "--checkpoint-dir", str(tmp_path / "snaps"), "--batch-size", "2",
               "--output-dir", str(out), "--attention-impl", "flash"])
    captured = capsys.readouterr()
    assert re.search(rf"^# {name}: attention flash ", captured.err, re.M)
    with open(out / "instruct_model_comparison_results.csv",
              newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == len(questions)
    assert not any(r["model_output"].startswith("MODEL_ERROR") for r in rows)
    assert all(0.0 <= float(r["relative_prob"]) <= 1.0 for r in rows)
