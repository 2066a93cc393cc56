"""Tokenizer access (counterpart of fairdiff/io/tokenizer.py).

A local CLIP tokenizer directory (`vocab.json`, `merges.txt`, and
optionally `tokenizer_config.json`) loads into `CLIPBPETokenizer`, the
port's own byte-level BPE, read with the standard library only: the card's
machine has no `transformers`. It gives the ids of `transformers`'
`CLIPTokenizer` as that class runs without ftfy (the JAX package's path
where ftfy is absent): the text is cleaned as its
`BasicTokenizer(strip_accents=False, do_split_on_punc=False)` cleans it and
lowercased, split into words with CLIP's pattern, mapped byte by byte onto
unicode, merged by rank, and framed by bos and eos. Without a directory, a
deterministic hash tokenizer with the same call contract (bos/eos/pad
semantics of CLIP) stands in.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import unicodedata
from pathlib import Path

import numpy as np

from fairdiff_torch.utils.rng import stable_hash

BOS, EOS = "<|startoftext|>", "<|endoftext|>"
# the merges CLIPTokenizer reads: the lines after the version header, at
# most 49152 - 256 - 2 of them
MAX_MERGES = 49152 - 256 - 2
# CLIP's context when the directory names none
DEFAULT_MAX_LENGTH = 77
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


@dataclasses.dataclass
class Tokenized:
    input_ids: np.ndarray  # [B, S] int32
    attention_mask: np.ndarray  # [B, S] int32


def _frame(seqs: list[list[int]], pad_id: int, padding: str, max_length: int) -> Tokenized:
    """Right-pad `seqs` with `pad_id` to `max_length` ("max_length") or to
    the longest ("longest"), with the attention mask."""
    width = max_length if padding == "max_length" else max(len(s) for s in seqs)
    ids = np.full((len(seqs), width), pad_id, np.int32)
    mask = np.zeros((len(seqs), width), np.int32)
    for i, s in enumerate(seqs):
        ids[i, : len(s)] = s[:width]
        mask[i, : len(s)] = 1
    return Tokenized(ids, mask)


class HashTokenizer:
    """Deterministic stand-in tokenizer (bos/eos/pad semantics match CLIP)."""

    def __init__(self, vocab_size: int = 49408, model_max_length: int = 77):
        self.vocab_size = vocab_size
        self.model_max_length = model_max_length
        self.bos_token_id = vocab_size - 2
        self.eos_token_id = vocab_size - 1
        self.pad_token_id = vocab_size - 1  # CLIP pads with eos

    def __call__(
        self, texts: list[str], padding: str = "longest", max_length: int | None = None
    ) -> Tokenized:
        max_length = max_length or self.model_max_length
        seqs = []
        for t in texts:
            words = t.lower().split()[: max_length - 2]
            ids = [self.bos_token_id]
            ids += [stable_hash(w) % (self.vocab_size - 2) for w in words]
            ids.append(self.eos_token_id)
            seqs.append(ids)
        return _frame(seqs, self.pad_token_id, padding, max_length)


@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte -> printable character map: the printable
    Latin-1 bytes map to themselves, the other 68 to chr(256 + n) in order."""
    keep = [*range(ord("!"), ord("~") + 1), *range(ord("¡"), ord("¬") + 1), *range(ord("®"), ord("ÿ") + 1)]
    out = {b: chr(b) for b in keep}
    for n, b in enumerate(b for b in range(256) if b not in out):
        out[b] = chr(256 + n)
    return out


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def clean_text(text: str) -> str:
    """`BasicTokenizer(strip_accents=False, do_split_on_punc=False)`, joined
    by spaces: control characters (and NUL, U+FFFD) dropped, whitespace made
    a space, CJK characters spaced apart, NFC, each word lowercased."""
    out = []
    for ch in text:
        cp = ord(ch)
        cat = unicodedata.category(ch)
        if ch in " \t\n\r" or cat == "Zs":
            out.append(" ")
        elif cp == 0 or cp == 0xFFFD or cat.startswith("C"):
            continue
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    words = unicodedata.normalize("NFC", "".join(out)).split()
    return " ".join(" ".join(w.lower() for w in words).split())


def _kind(ch: str) -> str:
    """"L" (letter), "N" (number), "S" (whitespace) or "P" (anything else):
    the classes of CLIP's pattern (`\\p{L}`, `\\p{N}`, `\\s`)."""
    if ch.isspace():
        return "S"
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "P"


def split_words(text: str) -> list[str]:
    """CLIP's pattern, `<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|
    [\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+` (case-insensitive), matched left to
    right with the first alternative that matches at each position (the
    literal ones under simple case folding)."""
    words, i, n = [], 0, len(text)
    while i < n:
        for special in (BOS, EOS, *_CONTRACTIONS):
            if text[i: i + len(special)].casefold() == special:
                words.append(text[i: i + len(special)])
                i += len(special)
                break
        else:
            kind = _kind(text[i])
            if kind == "S":
                i += 1
                continue
            j = i + 1
            if kind != "N":
                while j < n and _kind(text[j]) == kind:
                    j += 1
            words.append(text[i:j])
            i = j
    return words


class CLIPBPETokenizer:
    """The CLIP tokenizer of a local directory: `vocab.json` (token -> id,
    holding `<|startoftext|>` and `<|endoftext|>`), `merges.txt` (a version
    line, then one merge a line by rank) and, if present,
    `tokenizer_config.json`'s `model_max_length`. Unknown tokens map to
    `<|endoftext|>`, which also pads, as in CLIPTokenizer. The ids it writes
    are the vocabulary's whatever a caller sets `bos_token_id`,
    `eos_token_id` or `pad_token_id` to, as with the JAX package's wrapper
    of CLIPTokenizer."""

    def __init__(self, directory: str | Path):
        d = Path(directory)
        self.encoder: dict[str, int] = json.loads((d / "vocab.json").read_text(encoding="utf-8"))
        missing = [t for t in (BOS, EOS) if t not in self.encoder]
        if missing:
            raise ValueError(f"{d / 'vocab.json'} lacks the special tokens {missing}")
        lines = (d / "merges.txt").read_text(encoding="utf-8").strip().split("\n")[1: MAX_MERGES + 1]
        self.ranks = {tuple(line.split()): rank for rank, line in enumerate(lines)}
        config = d / "tokenizer_config.json"
        max_len = json.loads(config.read_text()).get("model_max_length") if config.exists() else None
        self.model_max_length = int(max_len or DEFAULT_MAX_LENGTH)
        self.vocab_size = len(self.encoder)
        self._bos, self._eos = self.encoder[BOS], self.encoder[EOS]
        self.bos_token_id, self.eos_token_id, self.pad_token_id = self._bos, self._eos, self._eos
        self._bytes = bytes_to_unicode()
        self._cache: dict[str, list[str]] = {BOS: [BOS], EOS: [EOS]}

    def bpe(self, word: str) -> list[str]:
        """The word's symbols after merging, lowest rank first, until no
        adjacent pair has a rank; the last symbol carries `</w>`."""
        if word in self._cache:
            return self._cache[word]
        symbols = [*word[:-1], word[-1] + "</w>"]
        while len(symbols) > 1:
            pairs = set(zip(symbols, symbols[1:]))
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(symbols):
                if i < len(symbols) - 1 and (symbols[i], symbols[i + 1]) == best:
                    merged.append(symbols[i] + symbols[i + 1])
                    i += 2
                else:
                    merged.append(symbols[i])
                    i += 1
            symbols = merged
        self._cache[word] = symbols
        return symbols

    def encode(self, text: str) -> list[int]:
        """The ids of `text` without bos and eos."""
        ids = []
        for word in split_words(clean_text(text)):
            mapped = "".join(self._bytes[b] for b in word.encode("utf-8"))
            ids += [self.encoder.get(s, self._eos) for s in self.bpe(mapped)]
        return ids

    def __call__(
        self, texts: list[str], padding: str = "longest", max_length: int | None = None
    ) -> Tokenized:
        """bos + ids + eos for each text, truncated to `max_length` (default
        `model_max_length`), padded to it ("max_length") or to the longest."""
        max_length = max_length or self.model_max_length
        seqs = [[self._bos, *self.encode(t)[: max_length - 2], self._eos] for t in texts]
        return _frame(seqs, self._eos, padding, max_length)


def load_tokenizer(path: str | Path | None):
    """CLIPBPETokenizer from a local directory when one is given, else
    HashTokenizer."""
    if path is None:
        return HashTokenizer()
    if not Path(path).exists():
        raise FileNotFoundError(f"tokenizer directory {path} does not exist")
    return CLIPBPETokenizer(path)
