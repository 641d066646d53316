"""The port's readers of the rosters' published tokenizer formats
(``utils/tokenizer.py`` on ``utils/tokenizer_parts.py``) against the
``tokenizers`` package and the JAX package's loader
(``runtime/loader.load_tokenizer``: ``transformers``' ``AutoTokenizer`` and
its pad rule) on the same files, each ``tokenizer.json`` built and trained
in process by the ``tokenizers`` package:

- Falcon's ``Sequence`` of Punctuation, ByteLevel, Digits and a ``Split``,
  at every split behaviour, Digits both ways, ``invert`` on and off;
- BLOOM's ``Split`` on its custom regex and ``ByteLevel(use_regex=false)``;
- Llama-2's / Mistral's byte-fallback BPE (``Prepend`` / ``Replace``
  normalizers, ``Replace`` / ``ByteFallback`` / ``Fuse`` / ``Strip``
  decoders, the BOS template that ``LlamaTokenizerFast`` rewrites from
  ``add_bos_token``), with a missing byte token, unfused unknowns and
  ``ignore_merges``;
- ``Metaspace`` at every prepend scheme x ``split``, in the BPE and the
  Unigram reader;
- T5's Unigram behind a ``Precompiled`` charsmap (built by
  ``chip_smoke._charsmap``, a darts-clone double array the package
  parses), keys where one is a prefix of another included.

Ids are identical (with and without special tokens) and so are decodes
(with and without skipping special tokens) on the legal scenarios, the 100
questions and their prompts, ``chip_smoke.TOKENIZER_EDGE_TEXTS`` and
invalid byte runs; one ``hypothesis`` test draws random text.  Oniguruma
patterns through the port's translation split as the package splits them,
and what the readers still refuse raises ``NotImplementedError`` naming
"Snapshot tokenizers".
"""

import functools
import json
import os

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from llm_interpretation_replication_tpu.runtime import loader as jloader
from llm_interpretation_replication_tpu_torch.config import (
    legal_scenarios, ordinary_meaning_questions)
from llm_interpretation_replication_tpu_torch.scoring import prompts
from llm_interpretation_replication_tpu_torch.utils import tokenizer as ttok
from llm_interpretation_replication_tpu_torch.utils import tokenizer_parts
from test_torch_slots import one_torch_thread  # noqa: F401
import chip_smoke

EXTRA_EDGE = [
    "<s>a</s> <s> </s>x", "Answer:Answer: Answer:", "q" * 40, "é" * 30,
    "é́̂ Å 각 क्ष",
    "\U0001f1fa\U0001f1f8\U0001f1fa x́‍\U0001f600",
    " " * 7 + "x" + "\t" * 3, "123456789012 ١٢٣٤٥ ①②③",
]


@functools.lru_cache(maxsize=None)
def texts():
    scen = legal_scenarios()
    out = [s[k] for s in scen
           for k in ("original_main", "response_format", "confidence_format")]
    out += [w for s in scen for t in s["target_tokens"] for w in (t, " " + t)]
    qs = ordinary_meaning_questions()
    out += qs + [prompts.format_prompt(q, b) for q in qs for b in (True, False)]
    return tuple(out + list(chip_smoke.TOKENIZER_EDGE_TEXTS) + EXTRA_EDGE)


@functools.lru_cache(maxsize=None)
def corpus():
    scen = legal_scenarios()
    return [s[k] for s in scen
            for k in ("original_main", "response_format",
                      "confidence_format")] + ordinary_meaning_questions()


def _trained(tok, trainer, added=(), byte_fallback=False, missing=None):
    """``tok`` trained on the corpus, with the 256 ``<0xXX>`` tokens
    appended to its vocabulary for byte fallback (one of them,
    ``missing``, renamed so its bytes fall back to ``<unk>``), then the
    normalized added tokens ``added``; as ``tokenizer.json``."""
    from tokenizers import AddedToken, Tokenizer

    tok.train_from_iterator(list(corpus()) * 2, trainer)
    if byte_fallback:
        spec = json.loads(tok.to_str())
        vocab = spec["model"]["vocab"]
        for b in range(256):
            vocab[f"<unused{b}>" if b == missing else f"<0x{b:02X}>"] = \
                len(vocab)
        tok = Tokenizer.from_str(json.dumps(spec))
    tok.add_tokens([AddedToken(t, normalized=True) for t in added])
    return json.loads(tok.to_str())


def falcon_json(behavior, individual, invert):
    from tokenizers import (Regex, Tokenizer, decoders, models,
                            pre_tokenizers, processors, trainers)

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Punctuation(behavior),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=True),
        pre_tokenizers.Digits(individual_digits=individual),
        pre_tokenizers.Split(Regex("[0-9][0-9][0-9]"), behavior,
                             invert=invert)])
    tok.decoder = decoders.ByteLevel()
    tok.post_processor = processors.ByteLevel(trim_offsets=False)
    return _trained(tok, trainers.BpeTrainer(
        vocab_size=900, special_tokens=[">>QUESTION<<", "<|endoftext|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()), ["Answer:"])


def bloom_json(behavior, invert, prefix_space):
    from tokenizers import (Regex, Tokenizer, decoders, models,
                            pre_tokenizers, processors, trainers)

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(" ?[^(\\s|[.,!?…。，、।۔،])]+"), behavior,
                             invert=invert),
        pre_tokenizers.ByteLevel(add_prefix_space=prefix_space,
                                 use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.post_processor = processors.ByteLevel(trim_offsets=False)
    return _trained(tok, trainers.BpeTrainer(
        vocab_size=900, special_tokens=["<unk>", "<s>", "</s>", "<pad>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))


def llama_json(variant):
    from tokenizers import (Tokenizer, decoders, models, normalizers,
                            processors, trainers)

    tok = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True,
                               fuse_unk=variant != "no_fuse",
                               ignore_merges=variant == "ignore_merges"))
    tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                           normalizers.Replace(" ", "▁")])
    tok.decoder = decoders.Sequence([
        decoders.Replace("▁", " "), decoders.ByteFallback(), decoders.Fuse(),
        decoders.Strip(" ", 1, 0)])
    spec = _trained(tok, trainers.BpeTrainer(
        vocab_size=700, special_tokens=["<unk>", "<s>", "</s>"],
        limit_alphabet=60), ["Answer:"], byte_fallback=True,
        missing=0xE4 if variant == "missing_byte" else None)
    spec["post_processor"] = json.loads(processors.TemplateProcessing(
        single="<s> $A", special_tokens=[("<s>", 1)]).__getstate__())
    return spec


def metaspace_json(reader, scheme, split):
    from tokenizers import (Regex, Tokenizer, decoders, models, normalizers,
                            pre_tokenizers, processors, trainers)

    meta = pre_tokenizers.Metaspace(prepend_scheme=scheme, split=split)
    if reader == "bpe":
        tok = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True,
                                   fuse_unk=True))
        tok.pre_tokenizer = meta
        tok.decoder = decoders.Sequence([
            decoders.ByteFallback(),
            decoders.Metaspace(prepend_scheme=scheme, split=split)])
        spec = _trained(tok, trainers.BpeTrainer(
            vocab_size=700, special_tokens=["<unk>", "<s>", "</s>"],
            limit_alphabet=60), ["Answer:"], byte_fallback=True)
        spec["post_processor"] = json.loads(processors.TemplateProcessing(
            single="<s> $A", special_tokens=[("<s>", 1)]).__getstate__())
        return spec
    tok = Tokenizer(models.Unigram())
    # Strip and Replace keep original offsets, which "first" reads
    tok.normalizer = normalizers.Sequence([
        normalizers.Strip(left=True, right=False),
        normalizers.Replace(Regex(" {2,}"), " ")])
    tok.pre_tokenizer = meta
    tok.decoder = decoders.Metaspace(prepend_scheme=scheme, split=split)
    spec = _trained(tok, trainers.UnigramTrainer(
        vocab_size=500, special_tokens=["<pad>", "</s>", "<unk>"],
        unk_token="<unk>", max_piece_length=12), ["Answer:"])
    spec["post_processor"] = json.loads(processors.TemplateProcessing(
        single="$A </s>", special_tokens=[("</s>", 1)]).__getstate__())
    return spec


#: keys where one is a prefix of another ("q" / "q́", "a" / "ab" /
#: "á"), multi-character keys, an empty value, CR LF
PREFIX_CHARSMAP = {"q": "Q", "q́": "X", "a": "A", "ab": "Y",
                   "á": "á", "́": "", "\r\n": "\n",
                   "é": "e", "é": "E", "👩": "W", "‍": "+",
                   "\U0001f1fa": "U", "　": " ", "ﬁ": "fi", "x‍": "x"}


def precompiled_json(charsmap, whitespace_split):
    from tokenizers import (Regex, Tokenizer, decoders, models, normalizers,
                            pre_tokenizers, processors, trainers)

    tok = Tokenizer(models.Unigram())
    tok.normalizer = normalizers.Sequence([
        normalizers.Precompiled(chip_smoke._charsmap(charsmap)),
        normalizers.Replace(Regex(" {2,}"), " ")])
    meta = pre_tokenizers.Metaspace(prepend_scheme="always")
    tok.pre_tokenizer = (pre_tokenizers.Sequence(
        [pre_tokenizers.WhitespaceSplit(), meta]) if whitespace_split
        else meta)
    tok.decoder = decoders.Metaspace(prepend_scheme="always")
    spec = _trained(tok, trainers.UnigramTrainer(
        vocab_size=500, special_tokens=["<pad>", "</s>", "<unk>"],
        unk_token="<unk>", max_piece_length=12))
    spec["post_processor"] = json.loads(processors.TemplateProcessing(
        single="$A </s>", special_tokens=[("</s>", 1)]).__getstate__())
    return spec


def _snapshot(tmp_path, spec, config):
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec))
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(config))
    return str(tmp_path)


def _invalid_runs(got, text):
    """Id lists whose bytes are cut mid-character: each prefix of the
    ids of the text's non-ASCII characters."""
    ids = got.encode(text, False)
    return [ids[:k] for k in range(1, min(len(ids), 12) + 1)]


def check(path, *, jax_skip=(), package_specials=True):
    """The port against the package and the JAX loader on ``texts()``:
    ids with and without special tokens, decodes with and without
    skipping them, pad and EOS ids."""
    from tokenizers import Tokenizer

    got = ttok.load_tokenizer(path)
    raw = Tokenizer.from_file(os.path.join(path, "tokenizer.json"))
    ref = jloader.load_tokenizer(path)
    for text in texts():
        plain = got.encode(text, False)
        assert plain == raw.encode(text, add_special_tokens=False).ids, \
            repr(text)
        with_specials = got.encode(text)
        if package_specials:
            assert with_specials == raw.encode(text).ids, repr(text)
        if not any(s in text for s in jax_skip):
            assert with_specials == ref(text).input_ids, repr(text)
            assert plain == ref(text, add_special_tokens=False).input_ids
        for ids in [with_specials] + (_invalid_runs(got, text)
                                       if not text.isascii() else []):
            for skip in (False, True):
                want = raw.decode(ids, skip_special_tokens=skip)
                assert got.decode(ids, skip) == want, (repr(text), ids)
                assert got.decode(ids, skip) == ref.decode(
                    ids, skip_special_tokens=skip), (repr(text), ids)
    assert (got.pad_token_id, got.eos_token_id) == (ref.pad_token_id,
                                                    ref.eos_token_id)
    return got


FALCON_CASES = [("contiguous", False, False), ("isolated", True, False),
                ("removed", False, True), ("merged_with_previous", True, False),
                ("merged_with_next", False, True)]


@pytest.mark.parametrize("behavior,individual,invert", FALCON_CASES)
def test_falcon_sequence(tmp_path, behavior, individual, invert):
    path = _snapshot(tmp_path, falcon_json(behavior, individual, invert),
                     {"tokenizer_class": "PreTrainedTokenizerFast",
                      "eos_token": "<|endoftext|>",
                      "add_prefix_space": False})
    got = check(path)
    assert got.eos_token_id == got.pad_token_id


@pytest.mark.parametrize("behavior,invert,prefix_space", [
    ("isolated", False, False), ("isolated", True, False),
    ("merged_with_next", False, True)])
def test_bloom_split(tmp_path, behavior, invert, prefix_space):
    path = _snapshot(tmp_path, bloom_json(behavior, invert, prefix_space),
                     {"tokenizer_class": "BloomTokenizerFast",
                      "unk_token": "<unk>", "bos_token": "<s>",
                      "eos_token": "</s>", "pad_token": "<pad>"})
    check(path)


@pytest.mark.parametrize("split", ["Whitespace", "WhitespaceSplit"])
def test_whitespace_sequence(tmp_path, split):
    """``Whitespace`` (the ``regex`` crate's ``\\w+|[^\\w\\s]+``) and
    ``WhitespaceSplit`` inside a ``Sequence``, before individual digits
    and a byte mapping."""
    from tokenizers import (Tokenizer, decoders, models, pre_tokenizers,
                            trainers)

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        getattr(pre_tokenizers, split)(),
        pre_tokenizers.Digits(individual_digits=True),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    spec = _trained(tok, trainers.BpeTrainer(
        vocab_size=800, special_tokens=["<|endoftext|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    check(_snapshot(tmp_path, spec, {
        "tokenizer_class": "PreTrainedTokenizerFast",
        "eos_token": "<|endoftext|>"}))


@pytest.mark.parametrize("add_bos,variant", [
    (True, "plain"), (False, "plain"), (True, "missing_byte"),
    (True, "no_fuse"), (False, "ignore_merges")])
def test_byte_fallback_bpe(tmp_path, add_bos, variant):
    """The JAX loader's ``LlamaTokenizerFast`` sets the BOS from
    ``add_bos_token`` whatever the file's template says; the package reads
    the file's ``<s> $A``."""
    path = _snapshot(tmp_path, llama_json(variant), {
        "tokenizer_class": "LlamaTokenizer", "add_bos_token": add_bos,
        "add_eos_token": False, "bos_token": "<s>", "eos_token": "</s>",
        "unk_token": "<unk>", "legacy": True})
    got = check(path, package_specials=add_bos)
    vocab = got.get_vocab()
    ids = got.encode("x 中")
    assert (ids[0] == vocab["<s>"]) == add_bos
    if variant == "missing_byte":      # <0xE4> is gone: 中 is unknown
        assert ids[-1] == got.unk_id
    else:
        assert ids[-3:] == [vocab[f"<0x{b:02X}>"] for b in "中".encode()]
    # an invalid run decodes to one U+FFFD a byte, as the package's
    assert got.decode([vocab["<0xE2>"], vocab["<0x82>"], vocab["a"]]) == \
        "\ufffd\ufffda"


@pytest.mark.parametrize("reader", ["bpe", "unigram"])
@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("scheme", ["always", "never", "first"])
def test_metaspace_schemes(tmp_path, reader, scheme, split):
    """"first" prepends ``▁`` only to the piece that starts the original
    text: not after an added token, nor after leading spaces a Strip
    normalizer removed."""
    config = ({"tokenizer_class": "LlamaTokenizer", "bos_token": "<s>",
               "eos_token": "</s>", "unk_token": "<unk>"} if reader == "bpe"
              else {"tokenizer_class": "PreTrainedTokenizerFast",
                    "eos_token": "</s>", "unk_token": "<unk>",
                    "pad_token": "<pad>"})
    path = _snapshot(tmp_path, metaspace_json(reader, scheme, split), config)
    got = check(path)
    rep = got.get_vocab()
    first = got.encode("Answer:Is it", False)
    assert first[0] == rep["Answer:"]
    if scheme == "first":
        assert got.encode("Is it", False) != got.encode("Answer:Is it",
                                                        False)[1:]


@pytest.mark.parametrize("charsmap", ["smoke", "prefixes"])
@pytest.mark.parametrize("whitespace_split", [False, True])
def test_precompiled_charsmap(tmp_path, charsmap, whitespace_split):
    """The package parses the test's double array and normalizes with it;
    the port reads the same bytes the same way, taking the first (shortest)
    common-prefix match for a whole grapheme cluster under 6 bytes."""
    mapping = chip_smoke.T5_CHARSMAP if charsmap == "smoke" else PREFIX_CHARSMAP
    path = _snapshot(tmp_path, precompiled_json(mapping, whitespace_split),
                     {"tokenizer_class": "T5Tokenizer", "eos_token": "</s>",
                      "unk_token": "<unk>", "pad_token": "<pad>"})
    check(path, jax_skip=("<extra_id",))


def test_precompiled_normalizer_against_the_package():
    """Normalization alone, text by text, with the package's
    ``Precompiled`` on the same bytes (grapheme clusters of marks, ZWJ
    sequences, regional indicators, Hangul, CR LF)."""
    from tokenizers import normalizers

    blob = chip_smoke._charsmap(PREFIX_CHARSMAP)
    ref = normalizers.Precompiled(blob)
    got = tokenizer_parts.Precompiled(blob)
    for text in texts():
        assert got(text) == ref.normalize_str(text), repr(text)
    assert got("q́") == "Q"          # the first match takes the cluster
    assert got("ab") == "Ab"              # "ab" spans two clusters


@functools.lru_cache(maxsize=None)
def _random_text_readers(tmp_dir):
    from tokenizers import Tokenizer

    out = []
    for name, spec in (("falcon", falcon_json("contiguous", False, False)),
                       ("llama", llama_json("plain")),
                       ("t5", precompiled_json(PREFIX_CHARSMAP, True))):
        raw = json.dumps(spec)
        out.append((name, ttok.load_tokenizer(_snapshot_dir(tmp_dir, name, raw)),
                    Tokenizer.from_str(raw)))
    return out


def _snapshot_dir(tmp_dir, name, raw):
    path = os.path.join(tmp_dir, name)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w") as f:
        f.write(raw)
    return path


@pytest.fixture(scope="module")
def random_text_readers(tmp_path_factory):
    return _random_text_readers(str(tmp_path_factory.mktemp("random")))


@settings(max_examples=150, derandomize=True, deadline=None)
@given(text=st.text(st.characters(exclude_categories=("Cs", "Cn")),
                    max_size=40))
def test_random_text(random_text_readers, text):
    """Random text of assigned code points (the package's Unicode tables
    are newer than this Python's ``unicodedata``, so a code point
    unassigned here may be a letter or a digit there)."""
    for name, got, raw in random_text_readers:
        ids = got.encode(text, False)
        assert ids == raw.encode(text, add_special_tokens=False).ids, \
            (name, text)
        assert got.decode(ids) == raw.decode(ids, skip_special_tokens=False)


ONIG_PATTERNS = [
    " ?[^(\\s|[.,!?…。，、।۔،])]+",
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+",
    "[a-z&&[^aeiou]]+", "\\h+", "\\bth\\w*\\b", "[\\p{Lu}\\p{Nd}]+",
    "\\d{2,3}", "x*", "[^\\p{L}\\p{N}\\s]+", "\\w+$", "^\\S+", "[\\x{4e00}-\\x{9fff}]+",
    "\\p{P}+|\\p{S}+", "\\P{L}+", "[\\-\\]\\[]",
]


@pytest.mark.parametrize("behavior", ["isolated", "merged_with_next",
                                      "contiguous"])
@pytest.mark.parametrize("pattern", ONIG_PATTERNS)
def test_oniguruma_translation_splits_as_the_package(pattern, behavior):
    from tokenizers import Regex, pre_tokenizers

    ref = pre_tokenizers.Split(Regex(pattern), behavior)
    got = tokenizer_parts.pre_tokenizer({"type": "Split", "pattern": {
        "Regex": pattern}, "behavior": behavior, "invert": False})
    for text in texts()[-40:]:
        assert [w for w, _ in got([(text, None)])] == \
            [w for w, _ in ref.pre_tokenize_str(text)], (pattern, text)


@pytest.mark.parametrize("what", [
    "wordpiece", "tokenizer.model", "spiece.model", "\\G", "(?<name>x)",
    "[[:alpha:]]", "\\X", "(a)\\1", "\\k<a>", "a{2}+"])
def test_still_refused(tmp_path, what):
    """WordPiece, SentencePiece model files and Oniguruma constructs the
    translation does not take raise ``NotImplementedError`` naming the
    ROADMAP item; nothing falls back to another reader."""
    if what == "wordpiece":
        (tmp_path / "tokenizer.json").write_text(json.dumps(
            {"model": {"type": "WordPiece", "vocab": {"[UNK]": 0},
                       "unk_token": "[UNK]"}}))
    elif what.endswith(".model"):
        (tmp_path / what).write_bytes(b"\x0a\x00")
    else:
        spec = json.loads(json.dumps(falcon_json("isolated", False, False)))
        spec["pre_tokenizer"] = {"type": "Split", "pattern": {"Regex": what},
                                 "behavior": "Isolated", "invert": False}
        (tmp_path / "tokenizer.json").write_text(json.dumps(spec))
    with pytest.raises(NotImplementedError, match="Snapshot tokenizers"):
        ttok.load_tokenizer(str(tmp_path))


def test_replace_normalizer_goes_through_the_translation():
    """A ``Replace`` regex is Oniguruma's too: ``\\s`` is White_Space
    (Python's adds U+001C-U+001F), and an untranslatable one refuses."""
    from tokenizers import Regex, normalizers

    got = tokenizer_parts.normalizer({"type": "Replace", "pattern": {
        "Regex": "\\s+"}, "content": "_"})
    ref = normalizers.Replace(Regex("\\s+"), "_")
    for text in texts()[-40:] + ("a\x1cb\x1d c",):
        assert got(text) == ref.normalize_str(text), repr(text)
    with pytest.raises(NotImplementedError, match="Snapshot tokenizers"):
        tokenizer_parts.normalizer({"type": "Replace", "pattern": {
            "Regex": "\\G "}, "content": ""})
