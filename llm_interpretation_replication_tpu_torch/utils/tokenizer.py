"""A small word-level tokenizer with the interface the engine uses.

The engine needs only ``__call__`` (returning ``input_ids`` both as a key
and as an attribute), ``encode``, ``decode``, ``pad_token_id`` and
``eos_token_id``; a Hugging Face tokenizer has them, and so does
:class:`WordTokenizer`, which needs no ``tokenizers`` package.  Like a
GPT-style vocabulary it tells ``" Yes"`` (a word after a space) from
``"Yes"`` (a word at the start of the text).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union


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
