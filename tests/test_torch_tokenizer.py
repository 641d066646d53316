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
    ("model", "byte_fallback", True),
    (None, "normalizer", {"type": "NFKC"}),
    (None, "pre_tokenizer", {"type": "Sequence", "pretokenizers": []}),
    (None, "pre_tokenizer", {"type": "Metaspace"}),
    (None, "post_processor", {"type": "TemplateProcessing"}),
    (None, "decoder", {"type": "Metaspace"}),
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
