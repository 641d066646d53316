"""The port's reader of a byte-level BPE ``tokenizer.json``
(``utils.tokenizer.load_tokenizer``) against the ``tokenizers`` package and
the JAX loader's ``load_tokenizer`` (``transformers``' ``AutoTokenizer``
plus its pad rule) on the same files: the test tokenizer
(``utils.testing.build_inprocess_tokenizer``, saved with its pad token
``"!"`` and no EOS) and the one ``chip_smoke.py`` builds for its snapshot.
Ids identical on every scenario text, format and target, digits,
punctuation, whitespace runs and Latin-1 text; decodes identical (with and
without special tokens); the pad rule as the reference loader applies it.
Text outside ASCII and Latin-1 is not pinned: ``\\p{L}`` and ``\\p{N}`` come
from this Python's Unicode tables, which may differ from the ones the
``tokenizers`` package was built with.
"""

import copy
import functools
import json
import os

import pytest

from llm_interpretation_replication_tpu.runtime import loader as jloader
from llm_interpretation_replication_tpu.utils.testing import build_inprocess_tokenizer
from llm_interpretation_replication_tpu_torch.config import legal_scenarios
from llm_interpretation_replication_tpu_torch.utils import tokenizer as ttok
import chip_smoke

LATIN1 = "".join(chr(c) for c in range(0xA0, 0x100))
EXTRA = [
    "Hello! Yes!x", "It's 1961; they'll pay 42.5% -- or 100?", "a\xa0\xa0b",
    "x  \n\n y   ", "\t tab\x0bvt\x0cff\rcr", "a\x1c\x1cb \x85 \x00",
    "½ 2² ³x ¹²³ ¼ café naïve ÿ×÷ ß µ ª º", LATIN1, "don't I'D we've 're",
    " leading space", "trailing space ", "", "!!!", "0 1 2 3 10 100 0.5",
    "<|endoftext|> in text<|endoftext|>x",
]


def texts():
    out = list(EXTRA)
    for s in legal_scenarios():
        out += [s["original_main"], s["response_format"],
                s["confidence_format"], f"{s['original_main']} "
                f"{s['response_format']}"]
        out += [t for w in s["target_tokens"] for t in (w, " " + w)]
    return out


@pytest.fixture(scope="module")
def test_snapshot(tmp_path_factory):
    path = tmp_path_factory.mktemp("tok")
    build_inprocess_tokenizer(300).save_pretrained(str(path))
    return str(path)


@functools.lru_cache(maxsize=None)
def smoke_files():
    return chip_smoke._bpe_tokenizer_files(
        [s[k] for s in legal_scenarios()
         for k in ("original_main", "response_format", "confidence_format")]
        + [" " + t for s in legal_scenarios() for t in s["target_tokens"]])


@pytest.fixture(scope="module")
def smoke_snapshot(tmp_path_factory):
    path = tmp_path_factory.mktemp("smoke_tok")
    spec, config, special = smoke_files()
    for name, obj in (("tokenizer.json", spec),
                      ("tokenizer_config.json", config),
                      ("special_tokens_map.json", special)):
        with open(path / name, "w", encoding="utf-8") as f:
            json.dump(obj, f)
    return str(path)


@pytest.mark.parametrize("which", ["test", "smoke"])
def test_ids_and_decodes_match_transformers(which, test_snapshot,
                                            smoke_snapshot):
    path = test_snapshot if which == "test" else smoke_snapshot
    ref, got = jloader.load_tokenizer(path), ttok.load_tokenizer(path)
    for text in texts():
        ids = got.encode(text)
        assert ids == ref(text)["input_ids"], text
        assert ids == ref(text, add_special_tokens=False)["input_ids"]
        for skip in (False, True):
            assert got.decode(ids, skip_special_tokens=skip) == \
                ref.decode(ids, skip_special_tokens=skip), text
    assert got(texts()[:3])["input_ids"] == ref(texts()[:3])["input_ids"]
    assert (got.pad_token_id, got.eos_token_id) == (ref.pad_token_id,
                                                    ref.eos_token_id)
    assert len(got) == len(ref)


@pytest.mark.parametrize("which", ["test", "smoke"])
def test_ids_match_the_tokenizers_package(which, test_snapshot,
                                          smoke_snapshot):
    """The raw ``tokenizer.json`` through ``tokenizers.Tokenizer``: ids
    (its added tokens split out), and text that round-trips."""
    from tokenizers import Tokenizer

    path = test_snapshot if which == "test" else smoke_snapshot
    ref = Tokenizer.from_file(os.path.join(path, "tokenizer.json"))
    got = ttok.load_tokenizer(path)
    for text in texts():
        ids = got.encode(text)
        if which == "smoke":            # its special tokens are all in the file
            assert ids == ref.encode(text).ids, text
        assert got.decode(ids) == ref.decode(ids, skip_special_tokens=False)
        assert got.decode(ids) == text


def test_smoke_tokenizer_merges_every_scenario_word(smoke_snapshot):
    """Each scenario word after a space (and each target) is one token."""
    tok = ttok.load_tokenizer(smoke_snapshot)
    for s in legal_scenarios():
        for w in s["original_main"].split()[1:]:
            pieces = ttok._byte_level_split().findall(" " + w)
            assert len(tok.encode(" " + w)) == len(pieces), w
        for t in s["target_tokens"]:
            assert len(tok.encode(" " + t)) == 1
    assert tok.eos_token_id == tok.pad_token_id == len(tok) - 1


SPECIAL = {"content": "Yes", "single_word": False, "lstrip": False,
           "rstrip": False, "normalized": False}


@pytest.mark.parametrize("config,special_map", [
    ({"pad_token": "!"}, None), ({"eos_token": "Y"}, None), ({}, None),
    ({"unk_token": "Z"}, None), ({"pad_token": "!"}, {"eos_token": SPECIAL}),
    ({"eos_token": "Y"}, {"eos_token": SPECIAL, "pad_token": "Z"}),
])
def test_pad_rule_matches_reference_loader(tmp_path, test_snapshot, config,
                                           special_map):
    """Without a pad token, the EOS pads, else ``<|endoftext|>``, else the
    unknown token, else the smallest id: the JAX loader's rule; the special
    tokens map overrides the tokenizer config."""
    with open(os.path.join(test_snapshot, "tokenizer.json")) as f:
        (tmp_path / "tokenizer.json").write_text(f.read())
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast", **config}))
    if special_map is not None:
        (tmp_path / "special_tokens_map.json").write_text(
            json.dumps(special_map))
    ref, got = jloader.load_tokenizer(str(tmp_path)), ttok.load_tokenizer(
        str(tmp_path))
    assert got.pad_token_id == ref.pad_token_id
    assert got.eos_token_id == ref.eos_token_id
    for text in texts()[:6]:
        ids = got.encode(text)
        assert ids == ref(text)["input_ids"]
        assert got.decode(ids, skip_special_tokens=True) == \
            ref.decode(ids, skip_special_tokens=True)


def _spec(test_snapshot):
    with open(os.path.join(test_snapshot, "tokenizer.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("edit", [
    ("model", "type", "WordPiece"),
    ("model", "dropout", 0.1),
    ("model", "continuing_subword_prefix", "##"),
    (None, "normalizer", {"type": "BertNormalizer"}),
    (None, "pre_tokenizer", {"type": "Sequence", "pretokenizers": [
        {"type": "BertPreTokenizer"}]}),
    (None, "pre_tokenizer", {"type": "Metaspace",
                             "prepend_scheme": "sometimes"}),
    (None, "post_processor", {"type": "RobertaProcessing"}),
    (None, "decoder", {"type": "WordPiece"}),
    (None, "truncation", {"max_length": 8}),
    (None, "added_tokens", [{"id": 0, "content": "!", "lstrip": True}]),
], ids=lambda e: f"{e[0]}.{e[1]}")
def test_other_components_raise(test_snapshot, edit):
    spec = copy.deepcopy(_spec(test_snapshot))
    part, key, value = edit
    (spec[part] if part else spec)[key] = value
    with pytest.raises(NotImplementedError, match="Snapshot tokenizers"):
        ttok.ByteLevelBPETokenizer(spec)


def test_engine_interface(test_snapshot):
    tok = ttok.load_tokenizer(test_snapshot)
    enc = tok("Is soup a beverage?")
    assert enc.input_ids == enc["input_ids"] == tok.encode("Is soup a beverage?")
    assert tok(["a", "b"]).input_ids == [tok.encode("a"), tok.encode("b")]
    assert tok.decode([10_000, 0, 5], skip_special_tokens=True) == \
        tok.decode([5])


# -- the NFC normalizer ----------------------------------------------------------

NFC_TEXTS = [
    "caf\u00e9 na\u00efve \u00c5ngstr\u00f6m",         # composed
    "cafe\u0301 nai\u0308ve A\u030angstro\u0308m",    # decomposed
    "a\u0300\u0301 e\u0301\u0301 o\u0323\u0302",  # stacked marks
    "\u1100\u1161\u11a8 \uac00",                  # Hangul jamo
    "\u0301 leading mark",
    "x\u0307\u0323y A\u030a \u2126",  # mark order, Angstrom, Ohm
    "Is a \"caf\u00e9\" a \"re\u0301sume\u0301\"? Answer either 'Yes' or 'No'.",
    "<|endoftext|>\u0301 after a special",
    "two  spaces\u0301  cafe\u0301",
    "cafe\u0301<|endoftext|>cafe\u0301",
    "",
]


@functools.lru_cache(maxsize=None)
def nfc_tokenizer_json(tmp_dir):
    """A byte-level BPE with the NFC normalizer, trained by the
    ``tokenizers`` package on NFD and NFC text, with a special added token
    (matched before normalization) and two normalized ones (after it,
    one written decomposed), saved as ``tokenizer.json`` in ``tmp_dir``."""
    import unicodedata

    from tokenizers import (AddedToken, Tokenizer, decoders, models,
                            normalizers, pre_tokenizers, processors, trainers)

    tok = Tokenizer(models.BPE())
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.post_processor = processors.ByteLevel(trim_offsets=True)
    corpus = []
    for text in texts() + NFC_TEXTS:
        corpus += [text, unicodedata.normalize("NFD", text),
                   unicodedata.normalize("NFC", text)]
    tok.train_from_iterator(corpus, trainers.BpeTrainer(
        vocab_size=700, special_tokens=["<|endoftext|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tok.add_tokens([AddedToken("  ", normalized=True),
                    AddedToken("re\u0301sume\u0301", normalized=True)])
    path = os.path.join(tmp_dir, "tokenizer.json")
    tok.save(path)
    return path


def test_nfc_normalizer_matches_the_tokenizers_package(tmp_path_factory):
    """GPT-NeoX-20B's normalizer: ids and decodes identical to the
    ``tokenizers`` package's on NFD input, stacked combining marks, Hangul
    jamo, a leading mark, and marks beside added tokens."""
    import unicodedata

    from tokenizers import Tokenizer

    path = nfc_tokenizer_json(str(tmp_path_factory.mktemp("nfc")))
    with open(path, encoding="utf-8") as f:
        spec = json.load(f)
    assert spec["normalizer"] == {"type": "NFC"}
    ref = Tokenizer.from_file(path)
    got = ttok.ByteLevelBPETokenizer(spec)
    for text in NFC_TEXTS + texts():
        for form in (text, unicodedata.normalize("NFD", text)):
            ids = got.encode(form)
            assert ids == ref.encode(form).ids, repr(form)
            assert got.decode(ids) == ref.decode(ids, skip_special_tokens=False)
    nfd = "re\u0301sume\u0301 cafe\u0301"
    assert got.encode(nfd)[0] == got.added["re\u0301sume\u0301"] == \
        ref.token_to_id("re\u0301sume\u0301")
    plain = dict(spec, normalizer=None)
    assert ttok.ByteLevelBPETokenizer(plain).encode(nfd) != got.encode(nfd)


# -- Unigram (T5), qwen.tiktoken (Qwen-1), vocab.json + merges.txt (OPT) -----

def _question_texts():
    from llm_interpretation_replication_tpu_torch.config import (
        ordinary_meaning_questions)
    from llm_interpretation_replication_tpu_torch.scoring import prompts

    qs = ordinary_meaning_questions()
    return qs + [prompts.format_prompt(q, b) for q in qs[:20]
                 for b in (True, False)] + ["Yes", "No"]


UNIGRAM_EDGE = ["Yes", "No", " Yes", "", " ", "  a  b  ", "x</s>y", "</s>",
                "<extra_id_0> Is it?", "ÉCOLE café ½ ﬁ", "tab\there\nnew",
                "Qzx9 ∑ 漢字", "a　b", "ab" * 30, "Is a \"tweet\" a 'post'?"]


@functools.lru_cache(maxsize=None)
def unigram_json(variant):
    """A Unigram ``tokenizer.json`` trained by the ``tokenizers`` package
    on the questions, T5's post-processor appending ``</s>``: ``plain``
    (a normalizer folding runs of spaces), ``folded`` (also NFKC,
    lowercase and strip), ``whitespace`` (``WhitespaceSplit`` before the
    Metaspace), ``never`` (no prefix ``▁``) and ``legacy`` (the old
    ``add_prefix_space`` spelling)."""
    from tokenizers import (Regex, Tokenizer, decoders, models, normalizers,
                            pre_tokenizers, processors, trainers)

    tok = Tokenizer(models.Unigram())
    norms = [normalizers.Replace(Regex(" {2,}"), " ")]
    if variant == "folded":
        norms += [normalizers.NFKC(), normalizers.Lowercase(),
                  normalizers.Strip()]
    tok.normalizer = normalizers.Sequence(norms)
    scheme = "never" if variant == "never" else "always"
    meta = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme=scheme)
    tok.pre_tokenizer = (pre_tokenizers.Sequence(
        [pre_tokenizers.WhitespaceSplit(), meta])
        if variant == "whitespace" else meta)
    tok.decoder = decoders.Metaspace(replacement="▁", prepend_scheme=scheme)
    specials = ["<pad>", "</s>", "<unk>"] + [f"<extra_id_{i}>" for i in range(3)]
    tok.train_from_iterator(_question_texts() * 2, trainers.UnigramTrainer(
        vocab_size=400, special_tokens=specials, unk_token="<unk>",
        max_piece_length=12))
    tok.post_processor = processors.TemplateProcessing(
        single="$A </s>", pair="$A </s> $B </s>",
        special_tokens=[("</s>", tok.token_to_id("</s>"))])
    spec = json.loads(tok.to_str())
    if variant == "legacy":
        for part in ("pre_tokenizer", "decoder"):
            spec[part] = {"type": "Metaspace", "replacement": "▁",
                          "add_prefix_space": True}
    return json.dumps(spec)


@pytest.mark.parametrize("variant", ["plain", "folded", "whitespace", "never",
                                     "legacy"])
def test_unigram_matches_the_tokenizers_package(variant):
    from tokenizers import Tokenizer

    raw = unigram_json(variant)
    ref = Tokenizer.from_str(raw)
    got = ttok.UnigramTokenizer(json.loads(raw))
    for text in _question_texts() + UNIGRAM_EDGE:
        for special in (True, False):
            ids = got.encode(text, special)
            assert ids == ref.encode(text, add_special_tokens=special).ids, \
                repr(text)
        for skip in (True, False):
            assert got.decode(ids, skip) == \
                ref.decode(ids, skip_special_tokens=skip), repr(text)


def test_smoke_unigram_files_match_tokenizers_and_transformers(tmp_path):
    """``chip_smoke``'s T5-style Unigram files: ids and decodes those of
    the ``tokenizers`` package and of the JAX loader's tokenizer;
    ``"Yes"`` opens with ``▁Yes`` and ``</s>`` closes every encoding."""
    from tokenizers import Tokenizer

    texts = _question_texts()
    for name, obj in zip(("tokenizer.json", "tokenizer_config.json",
                          "special_tokens_map.json"),
                         chip_smoke._unigram_tokenizer_files(texts)):
        (tmp_path / name).write_text(json.dumps(obj))
    got = ttok.load_tokenizer(str(tmp_path))
    ref = jloader.load_tokenizer(str(tmp_path))
    raw = Tokenizer.from_file(str(tmp_path / "tokenizer.json"))
    assert isinstance(got, ttok.UnigramTokenizer)
    for text in texts + UNIGRAM_EDGE:
        ids = got.encode(text)
        assert ids == raw.encode(text).ids, repr(text)
        # transformers' T5 class adds <extra_id_*> specials these files lack
        if "<extra_id" not in text:
            assert ids == ref(text).input_ids, repr(text)
        assert ids[-1] == got.eos_token_id == 1
        assert got.decode(ids, True) == ref.decode(ids, skip_special_tokens=True)
    yes = got("Yes").input_ids
    assert got.id_to_token[yes[0]] == "▁Yes" and yes[1:] == [1]
    assert (got.pad_token_id, got.eos_token_id) == (ref.pad_token_id,
                                                    ref.eos_token_id)


FIRST = {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first",
         "split": True}


@pytest.mark.parametrize("edit", [
    # a charsmap is read, but not before a Metaspace "first", which reads
    # original offsets a charsmap does not carry
    ("normalizer", {"type": "Precompiled", "precompiled_charsmap":
                    chip_smoke._charsmap_b64({"x": "y"})},
     {"pre_tokenizer": FIRST}),
    ("normalizer", {"type": "BertNormalizer"}),
    ("pre_tokenizer", {"type": "ByteLevel"}),
    # "first" is read, but not after NFKC (the same reason)
    ("pre_tokenizer", FIRST, {"normalizer": {"type": "NFKC"}}),
    ("decoder", {"type": "ByteLevel"}),
    ("post_processor", {"type": "RobertaProcessing"}),
    ("model", {"type": "Unigram", "unk_id": 2, "vocab": [["a", 0.0]],
               "byte_fallback": True}),
], ids=lambda e: f"{e[0]}.{e[1]['type']}")
def test_other_unigram_components_raise(edit):
    spec = json.loads(unigram_json("plain"))
    spec[edit[0]] = edit[1]
    spec.update(edit[2] if len(edit) > 2 else {})
    with pytest.raises(NotImplementedError, match="Snapshot tokenizers"):
        ttok.UnigramTokenizer(spec)


def test_empty_precompiled_normalizer_is_the_identity():
    spec = json.loads(unigram_json("plain"))
    plain = ttok.UnigramTokenizer(spec)
    spec["normalizer"] = {"type": "Sequence", "normalizers": [
        {"type": "Precompiled", "precompiled_charsmap": ""},
        spec["normalizer"]]}
    got = ttok.UnigramTokenizer(spec)
    for text in UNIGRAM_EDGE:
        assert got.encode(text) == plain.encode(text)


QWEN_PAT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
            r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")


def test_qwen_tiktoken_matches_tiktoken(tmp_path):
    """``chip_smoke``'s ``qwen.tiktoken`` read by the port against a
    ``tiktoken`` encoding of the same ranks, Qwen's pattern and special
    tokens (allowed, so the pattern never splits them), on NFC text."""
    import base64
    import unicodedata

    tiktoken = pytest.importorskip("tiktoken")
    blob = chip_smoke._qwen_tiktoken(_question_texts())
    (tmp_path / "qwen.tiktoken").write_bytes(blob)
    ranks = {base64.b64decode(t): int(r)
             for t, r in (line.split() for line in blob.splitlines())}
    ref = tiktoken.Encoding(
        "qwen-test", pat_str=QWEN_PAT, mergeable_ranks=ranks,
        special_tokens={t: ttok.QWEN_SPECIAL_START + i
                        for i, t in enumerate(ttok.QWEN_SPECIALS)})
    got = ttok.load_tokenizer(str(tmp_path))
    assert isinstance(got, ttok.QwenTokenizer)
    edge = ["", "It's 1961; THEY'LL pay 42.5%\r\n\n  x", "'S 'T don'T",
            "<|endoftext|>a<|im_start|>b<|extra_12|>c<|extra_1|>",
            "café naïve 漢字 ½", "a\n\n\n  b   "]
    for text in _question_texts() + edge:
        ids = got.encode(text)
        assert ids == ref.encode(unicodedata.normalize("NFC", text),
                                 allowed_special="all"), repr(text)
        assert got.decode(ids) == ref.decode(ids)
    assert got.encode("<|im_end|>") == [ttok.QWEN_SPECIAL_START + 2]
    assert got.decode(got.encode("a<|endoftext|>b"), skip_special_tokens=True) \
        == "ab"
    assert got.pad_token_id == ttok.QWEN_SPECIAL_START and got.eos_token_id is None


@pytest.mark.parametrize("add_bos", [False, True])
def test_vocab_and_merges_match_transformers(tmp_path, add_bos):
    """A ``vocab.json`` + ``merges.txt`` snapshot (no ``tokenizer.json``):
    ids and decodes those of ``transformers``' GPT-2 tokenizer on the same
    files, OPT's ``</s>`` BOS in front when the config asks, and the
    ``tokenizers`` package's ByteLevel BPE without it."""
    from tokenizers import ByteLevelBPETokenizer
    from transformers import AutoTokenizer

    chip_smoke._write_gpt2_tokenizer(str(tmp_path), _question_texts())
    conf = json.loads((tmp_path / "tokenizer_config.json").read_text())
    (tmp_path / "tokenizer_config.json").write_text(
        json.dumps(dict(conf, add_bos_token=add_bos)))
    got = ttok.load_tokenizer(str(tmp_path))
    ref = AutoTokenizer.from_pretrained(str(tmp_path))
    raw = ByteLevelBPETokenizer(str(tmp_path / "vocab.json"),
                                str(tmp_path / "merges.txt"))
    for text in _question_texts() + EXTRA:
        for special in (True, False):
            assert got(text, special).input_ids == \
                ref(text, add_special_tokens=special).input_ids, repr(text)
        ids = got.encode(text)
        assert got.encode(text, False) == raw.encode(text).ids
        for skip in (True, False):
            assert got.decode(ids, skip) == \
                ref.decode(ids, skip_special_tokens=skip)
    assert (got.pad_token_id, got.eos_token_id) == (ref.pad_token_id,
                                                    ref.eos_token_id)


def test_load_tokenizer_picks_the_reader_from_the_files(tmp_path):
    """A SentencePiece model file alone is read by the reader its model
    type needs (Unigram as T5's conversion, BPE as Llama's), under either
    file name; a model type the conversions do not cover refuses; no file
    at all is an error."""
    texts = [s["original_main"] for s in legal_scenarios()]
    for fmt, reader in (("sp_unigram", ttok.UnigramTokenizer),
                        ("sp_bpe", ttok.ByteLevelBPETokenizer)):
        (name, blob), _, _ = chip_smoke._format_tokenizer_files(fmt, texts)
        for fname in ("tokenizer.model", "spiece.model"):
            (tmp_path / fname).write_bytes(blob)
            assert isinstance(ttok.load_tokenizer(str(tmp_path)), reader)
            (tmp_path / fname).unlink()
    (tmp_path / "tokenizer.model").write_bytes(b"\x12\x02\x18\x03")  # WORD
    with pytest.raises(NotImplementedError, match="Snapshot tokenizers"):
        ttok.load_tokenizer(str(tmp_path))
    (tmp_path / "tokenizer.model").unlink()
    with pytest.raises(FileNotFoundError, match="no tokenizer files"):
        ttok.load_tokenizer(str(tmp_path))


# -- the smoke's published-format writers (chip_smoke._format_tokenizer_files)

@functools.lru_cache(maxsize=None)
def smoke_format_dir(fmt, tmp_dir):
    path = os.path.join(tmp_dir, fmt)
    os.makedirs(path, exist_ok=True)
    chip_smoke._write_tokenizer_files(path, chip_smoke._format_tokenizer_files(
        fmt, chip_smoke._tokenizer_learn_texts()))
    return path


def format_oracles(fmt, path):
    """(the reference's tokenizer, the raw ``tokenizers`` one) of a smoke
    format's files: the JAX loader and ``tokenizer.json``, or for a
    SentencePiece model file (which the JAX loader needs the
    ``sentencepiece`` library to read) ``transformers``' conversion of it
    in its fast tokenizer class and that fast tokenizer again."""
    from tokenizers import Tokenizer

    if fmt.startswith("sp_"):
        from test_torch_sentencepiece import converter_oracle

        ref = converter_oracle(path)[0]
        return ref, ref
    return (jloader.load_tokenizer(path),
            Tokenizer.from_file(os.path.join(path, "tokenizer.json")))


def raw_ids(raw, text):
    got = raw.encode(text)
    return got.ids if hasattr(got, "ids") else got


@pytest.mark.parametrize("fmt", sorted(chip_smoke.TOKENIZER_FORMATS))
def test_smoke_format_files_match_tokenizers_and_transformers(
        fmt, tmp_path_factory):
    """Each format ``chip_smoke.py`` writes for the CLI snapshots and the
    tokenizers phase: ids (with and without special tokens) and decodes
    those of the ``tokenizers`` package and of the JAX loader, on the
    digest texts and the sweep's rephrasings; the reader the format
    needs; every text back from a decode (T5's: normalized)."""
    path = smoke_format_dir(fmt, str(tmp_path_factory.mktemp(fmt)))
    got = ttok.load_tokenizer(path)
    ref, raw = format_oracles(fmt, path)
    unigram = fmt in ("t5", "sp_unigram")
    assert isinstance(got, ttok.UnigramTokenizer if unigram
                      else ttok.ByteLevelBPETokenizer)
    rephrasings = [r for rec in chip_smoke._perturbation_records(0)
                   for r in rec["rephrasings"][:4]]
    for text in chip_smoke._tokenizer_digest_texts() + rephrasings:
        ids = got.encode(text)
        assert ids == raw_ids(raw, text) == ref(text).input_ids, repr(text)
        assert got.encode(text, False) == ref(
            text, add_special_tokens=False).input_ids
        for skip in (True, False):
            assert got.decode(ids, skip) == ref.decode(
                ids, skip_special_tokens=skip) == raw.decode(
                    ids, skip_special_tokens=skip), repr(text)
    for text in rephrasings:
        back = got.decode(got.encode(text), skip_special_tokens=True)
        assert back == (got._normalize(text).replace("▁", " ") if unigram
                        else text)
    assert (got.pad_token_id, got.eos_token_id) == (ref.pad_token_id,
                                                    ref.eos_token_id)


@pytest.mark.parametrize("fmt", sorted(chip_smoke.TOKENIZER_FORMATS))
def test_smoke_tokenizer_digests_match_the_package(fmt, tmp_path_factory):
    """The digests the tokenizers phase holds the card's reader to are
    the ``tokenizers`` package's and the JAX loader's ids on the same
    files (and the port's here)."""
    path = smoke_format_dir(fmt, str(tmp_path_factory.mktemp(fmt)))
    texts_ = chip_smoke._tokenizer_digest_texts()
    ref, raw = format_oracles(fmt, path)
    want = chip_smoke.TOKENIZER_DIGESTS[fmt]
    assert chip_smoke._ids_digest(raw_ids(raw, t) for t in texts_) == want
    assert chip_smoke._ids_digest(ref(t).input_ids for t in texts_) == want
    got = ttok.load_tokenizer(path)
    assert chip_smoke._ids_digest(got.encode(t) for t in texts_) == want
