"""Tokenizers, self-contained (no hub download): CLIP's byte-level BPE for
the text towers, GPT-2's for BLIP-2's OPT decoder and BERT's WordPiece for
GroundingDINO's text encoder.

Counterpart of ``CLIPTokenizer``, ``GPT2Tokenizer``, ``BertTokenizer``,
``tiny_tokenizer``, ``tiny_gpt2_tokenizer`` and ``tiny_bert_tokenizer`` in
``editanything_tpu/text/tokenizer.py``, carried
into the port so that the port, and a GPU machine that runs it, needs
nothing of the JAX package. The CLIP tokenizer has the same vocabulary
layout (256 byte symbols, 256 byte+'</w>' symbols, the
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

import numpy as np


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

    def __call__(self, texts, *, pad_to: Optional[int] = None,
                 truncate: bool = False) -> np.ndarray:
        """Prompts -> (B, L) int32 rows [BOS, ids, EOS, EOS...], the JAX
        tokenizer's ``__call__``: L is `pad_to`, else the longest row; with
        `truncate` the ids are cut to `pad_to` (or the context length)
        minus 2 first."""
        if isinstance(texts, str):
            texts = [texts]
        all_ids = [self.encode(t) for t in texts]
        if truncate:
            limit = (pad_to or self.context_length) - 2
            all_ids = [ids[:limit] for ids in all_ids]
        length = pad_to or (max(len(i) for i in all_ids) + 2)
        out = np.full((len(all_ids), length), self.eos_id, np.int32)
        for r, ids in enumerate(all_ids):
            row = [self.bos_id] + list(ids[:length - 2]) + [self.eos_id]
            out[r, :len(row)] = row
        return out

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


class GPT2Tokenizer:
    """Byte-level BPE as GPT-2 and OPT use it (BLIP-2's language side):
    no '</w>' end-of-word marker (a leading space is part of the token, as
    the byte symbol 'Ġ'), no lowercasing, GPT-2's split pattern. The
    vocabulary maps token strings to ids (HF's ``vocab.json``); the merges
    are in rank order (HF's ``merges.txt``). ``decode`` drops bos and pad."""

    _PAT = re.compile(
        r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?[^\s\w]+|\s+(?!\S)|\s+",
        re.UNICODE)

    def __init__(self, vocab: Dict[str, int], merges: Sequence[str],
                 bos_token: str = "</s>", eos_token: str = "</s>",
                 pad_token: str = "<pad>"):
        self.byte_encoder = bytes_to_unicode()
        self.encoder = dict(vocab)
        self.decoder = {i: t for t, i in self.encoder.items()}
        pairs = [tuple(m.split()) for m in merges if m.strip()]
        self.bpe_ranks = {p: i for i, p in enumerate(pairs)}
        self.cache: Dict[str, str] = {}
        self.bos_id = self.encoder.get(bos_token, 2)
        self.eos_id = self.encoder.get(eos_token, 2)
        self.pad_id = self.encoder.get(pad_token, 1)

    @classmethod
    def from_files(cls, vocab_json: str, merges_txt: str,
                   **kw) -> "GPT2Tokenizer":
        """From HF's ``vocab.json`` and ``merges.txt`` (its ``#version``
        header line skipped)."""
        with open(vocab_json, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_txt, encoding="utf-8") as f:
            lines = f.read().split("\n")
        if lines and lines[0].startswith("#version"):
            lines = lines[1:]
        return cls(vocab, lines, **kw)

    def bpe(self, token: str) -> str:
        """Apply the merges to one pre-split token; space-joined symbols."""
        if token in self.cache:
            return self.cache[token]
        word = tuple(token)
        pairs = _get_pairs(word) if len(word) > 1 else set()
        while pairs:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        """Text -> token ids (no bos, no eos)."""
        ids: List[int] = []
        for token in self._PAT.findall(text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        """Token ids -> text; bos and pad dropped, unknown ids skipped,
        invalid UTF-8 replaced."""
        byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        text = "".join(self.decoder.get(int(i), "") for i in ids
                       if int(i) not in (self.bos_id, self.pad_id))
        raw = bytearray(byte_decoder[c] for c in text if c in byte_decoder)
        return raw.decode("utf-8", errors="replace")


def tiny_gpt2_tokenizer(words: Sequence[str] = ("a", "cat", "dog", "photo")
                        ) -> GPT2Tokenizer:
    """Small GPT-2-style tokenizer for tests and random-weight runs: the 256
    byte symbols (ids 3-258 after <pad> 1 and </s> 2) and merges that build
    each word, plain and with its leading space 'Ġ', left to right."""
    merges: List[str] = []
    toks: List[str] = []
    for w in words:
        for prefix in ("", "Ġ"):
            chars = list(prefix + w)
            while len(chars) > 1:
                merges.append(f"{chars[0]} {chars[1]}")
                chars = [chars[0] + chars[1]] + chars[2:]
                toks.append(chars[0])
    vocab = {"<pad>": 1, "</s>": 2}
    for t in list(bytes_to_unicode().values()) + toks:
        if t not in vocab:
            vocab[t] = len(vocab) + 1
    return GPT2Tokenizer(vocab, list(dict.fromkeys(merges)))


class BertTokenizer:
    """WordPiece tokenizer with bert-base-uncased's basic split (lowercase,
    alphanumeric runs, every other non-space character alone), for
    GroundingDINO's text side; the vocabulary is the user's ``vocab.txt``
    (one token per line, the id its line number)."""

    def __init__(self, vocab: Dict[str, int]):
        self.vocab = dict(vocab)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.cls_id = self.vocab.get("[CLS]", 101)
        self.sep_id = self.vocab.get("[SEP]", 102)
        self.pad_id = self.vocab.get("[PAD]", 0)
        self.unk_id = self.vocab.get("[UNK]", 100)

    @classmethod
    def from_file(cls, vocab_txt: str) -> "BertTokenizer":
        with open(vocab_txt, encoding="utf-8") as f:
            toks = [line.rstrip("\n") for line in f]
        return cls({t: i for i, t in enumerate(toks)})

    @staticmethod
    def _basic(text: str) -> List[str]:
        out: List[str] = []
        word = ""
        for ch in text.lower():
            if ch.isalnum():
                word += ch
                continue
            if word:
                out.append(word)
                word = ""
            if not ch.isspace():
                out.append(ch)
        if word:
            out.append(word)
        return out

    def _wordpiece(self, word: str) -> List[str]:
        """Greedy longest-prefix pieces, continuations marked "##"; a word
        with an unmatched part is one [UNK]."""
        if word in self.vocab:
            return [word]
        pieces, start = [], 0
        while start < len(word):
            for end in range(len(word), start, -1):
                sub = word[start:end] if start == 0 else "##" + word[start:end]
                if sub in self.vocab:
                    break
            else:
                return ["[UNK]"]
            pieces.append(sub)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        return [p for w in self._basic(text) for p in self._wordpiece(w)]

    def encode_padded(self, text: str, max_len: int):
        """-> (ids (max_len,) int32, mask (max_len,) bool, tokens): [CLS],
        the text's tokens cut to max_len - 2, [SEP], then [PAD]s."""
        import numpy as np
        tokens = ["[CLS]"] + self.tokenize(text)[:max_len - 2] + ["[SEP]"]
        ids = np.full((max_len,), self.pad_id, np.int32)
        ids[:len(tokens)] = [self.vocab.get(t, self.unk_id) for t in tokens]
        mask = np.zeros((max_len,), bool)
        mask[:len(tokens)] = True
        return ids, mask, tokens


def tiny_bert_tokenizer(words: Sequence[str] = ("a", "dog", "head", "cat",
                                                "sofa")) -> BertTokenizer:
    """Small WordPiece vocabulary for tests: [PAD] 0, [UNK] 1, [CLS] 2,
    [SEP] 3, "." 4, the words, then every letter and its "##" form."""
    vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, ".": 4}
    for w in words:
        vocab.setdefault(w, len(vocab))
    for ch in "abcdefghijklmnopqrstuvwxyz":
        for p in (ch, "##" + ch):
            vocab.setdefault(p, len(vocab))
    return BertTokenizer(vocab)
