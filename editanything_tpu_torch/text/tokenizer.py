"""CLIP byte-level BPE tokenizer, self-contained (no hub download).

Counterpart of ``CLIPTokenizer`` and ``tiny_tokenizer`` in
``editanything_tpu/text/tokenizer.py``, carried into the port so that the
port, and a GPU machine that runs it, needs nothing of the JAX package.
Same vocabulary layout (256 byte symbols, 256 byte+'</w>' symbols, the
merges in rank order, then <|startoftext|> and <|endoftext|>), the same
text cleanup (html-unescape, whitespace collapse, lowercase) and the same
split pattern, so both give the same ids for the same merges. The merges
come as a list or from a file: OpenAI's ``bpe_simple_vocab_16e6.txt.gz``
or HF's ``merges.txt`` (with ``vocab.json``, ``from_hf``). Textual-inversion
placeholders encode to their registered ids verbatim.
"""

from __future__ import annotations

import gzip
import html
import json
import re
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte -> printable-unicode map."""
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
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text)).strip()
    return re.sub(r"\s+", " ", text).strip().lower()


# CLIP's token split pattern, with Python `re` classes in place of \p{L}/\p{N}
_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|[^\s\w]+",
    re.IGNORECASE | re.UNICODE)


class CLIPTokenizer:
    """Encode prompt strings to CLIP token ids, from merges in rank order
    (["a b", ...]) or the file at `vocab_path`
    (``bpe_simple_vocab_16e6.txt(.gz)`` or ``merges.txt``)."""

    def __init__(self, merges: Optional[Sequence[str]] = None,
                 vocab_path: Optional[str] = None, context_length: int = 77):
        if merges is None:
            if vocab_path is None:
                raise ValueError(
                    "CLIPTokenizer needs `merges` or `vocab_path` "
                    "(bpe_simple_vocab_16e6.txt.gz or merges.txt)")
            merges = _load_merges(vocab_path)
        self.byte_encoder = bytes_to_unicode()
        merge_pairs = [tuple(m.split()) for m in merges]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(pair) for pair in merge_pairs]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {p: i for i, p in enumerate(merge_pairs)}
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.bos_id = self.encoder["<|startoftext|>"]
        self.eos_id = self.encoder["<|endoftext|>"]
        self.context_length = context_length
        # textual-inversion placeholders: string -> the ids of its appended
        # embedding rows (a multi-vector placeholder maps to all of them)
        self.placeholders: Dict[str, List[int]] = {}

    def add_placeholder(self, token: str, ids: Sequence[int]) -> None:
        """Register a placeholder string that encodes to `ids` verbatim."""
        self.placeholders[token] = [int(i) for i in ids]

    @classmethod
    def from_hf(cls, vocab_json: str, merges_txt: str,
                context_length: int = 77) -> "CLIPTokenizer":
        """From HF's ``vocab.json`` + ``merges.txt``; the special tokens'
        ids must be CLIP's canonical ones."""
        tok = cls(merges=_load_merges(merges_txt),
                  context_length=context_length)
        with open(vocab_json, encoding="utf-8") as f:
            hf_vocab = json.load(f)
        for anchor in ("<|startoftext|>", "<|endoftext|>"):
            if anchor in hf_vocab and hf_vocab[anchor] != tok.encoder[anchor]:
                raise ValueError(f"{vocab_json}: {anchor} is id "
                                 f"{hf_vocab[anchor]}, CLIP's layout has "
                                 f"{tok.encoder[anchor]}")
        return tok

    def bpe(self, token: str) -> str:
        """Apply the merges to one pre-split token; space-joined symbols."""
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        while pairs:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if (word[i] == first and i + 1 < len(word)
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        """Text -> token ids (no BOS/EOS, no padding); registered
        placeholders are spliced in as their ids."""
        if self.placeholders and any(ph in text for ph in self.placeholders):
            pattern = "|".join(re.escape(ph) for ph in sorted(
                self.placeholders, key=len, reverse=True))
            ids: List[int] = []
            for piece in re.split(f"({pattern})", text):
                if piece in self.placeholders:
                    ids.extend(self.placeholders[piece])
                elif piece.strip():
                    ids.extend(self._encode_bpe(piece))
            return ids
        return self._encode_bpe(text)

    def _encode_bpe(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in _PAT.findall(_clean(text)):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        """Token ids -> text, '</w>' as spaces."""
        byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(byte_decoder[c] for c in text if c in byte_decoder)
        return (raw.decode("utf-8", errors="replace")
                .replace("</w>", " ").strip())


def _load_merges(path: str) -> List[str]:
    """The merges of HF's ``merges.txt`` (after its ``#version`` line) or of
    OpenAI's ``bpe_simple_vocab_16e6.txt(.gz)`` (lines 1 to 48894, the
    slice open_clip's SimpleTokenizer takes)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
        lines = f.read().split("\n")
    if lines and lines[0].startswith("#version"):
        return [l for l in lines[1:] if l.strip()]
    return [l for l in lines[1:49152 - 256 - 2 + 1] if l.strip()]


def tiny_tokenizer(words: Sequence[str] = ("photo", "of", "a", "cat", "dog"),
                   context_length: int = 77) -> CLIPTokenizer:
    """Deterministic small tokenizer for tests and random-weight runs:
    merges that build the given words character by character, left to
    right."""
    merges: List[str] = []
    for w in words:
        chars = list(w[:-1]) + [w[-1] + "</w>"]
        while len(chars) > 1:
            merges.append(f"{chars[0]} {chars[1]}")
            chars = [chars[0] + chars[1]] + chars[2:]
    return CLIPTokenizer(merges=list(dict.fromkeys(merges)),
                         context_length=context_length)
