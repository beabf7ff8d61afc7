"""The umT5 tokenizer wrapper with Wan's text cleaning, and the text
encoder that turns prompts into states.

Port of `mmpl_tpu/utils/tokenizer.py`.  The cleaning modes (whitespace /
lower / canonicalize) and the max-length padding that returns numpy
(ids, mask) are the JAX package's.  `ftfy` is optional: without it the
mojibake repair is skipped (HTML unescaping and stripping are kept).
`transformers` is imported when a tokenizer is built.

`WanTextEncoder` is two steps: `tokenize` (strings -> ids and mask, needs
`transformers` and the tokenizer files) and `encode_ids` (ids -> states
through `models/t5.T5Encoder`, needs neither).
"""

from __future__ import annotations

import html
import re
import string
from typing import Optional, Sequence, Union

import numpy as np
import torch

try:
    import ftfy
    _HAS_FTFY = True
except ImportError:  # pragma: no cover
    _HAS_FTFY = False


def basic_clean(text: str) -> str:
    if _HAS_FTFY:
        text = ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def canonicalize(text: str,
                 keep_punctuation_exact_string: Optional[str] = None) -> str:
    text = text.replace("_", " ")
    if keep_punctuation_exact_string:
        text = keep_punctuation_exact_string.join(
            part.translate(str.maketrans("", "", string.punctuation))
            for part in text.split(keep_punctuation_exact_string))
    else:
        text = text.translate(str.maketrans("", "", string.punctuation))
    text = text.lower()
    return re.sub(r"\s+", " ", text).strip()


class HuggingfaceTokenizer:
    """A `transformers` tokenizer from a local directory (or hub name),
    with an optional cleaning mode and fixed-length padding."""

    def __init__(self, name: str, seq_len: Optional[int] = None,
                 clean: Optional[str] = None, **kwargs):
        assert clean in (None, "whitespace", "lower", "canonicalize")
        from transformers import AutoTokenizer
        self.name = name
        self.seq_len = seq_len
        self.clean = clean
        self.tokenizer = AutoTokenizer.from_pretrained(name, **kwargs)
        self.vocab_size = self.tokenizer.vocab_size

    def _clean(self, text: str) -> str:
        if self.clean == "whitespace":
            return whitespace_clean(basic_clean(text))
        if self.clean == "lower":
            return whitespace_clean(basic_clean(text)).lower()
        if self.clean == "canonicalize":
            return canonicalize(basic_clean(text))
        return text

    def __call__(self, sequence: Union[str, Sequence[str]],
                 return_mask: bool = False, **kwargs):
        kw = {"return_tensors": "np"}
        if self.seq_len is not None:
            kw.update(padding="max_length", truncation=True,
                      max_length=self.seq_len)
        kw.update(kwargs)
        if isinstance(sequence, str):
            sequence = [sequence]
        if self.clean:
            sequence = [self._clean(u) for u in sequence]
        out = self.tokenizer(list(sequence), **kw)
        ids = np.asarray(out["input_ids"], dtype=np.int32)
        if return_mask:
            return ids, np.asarray(out["attention_mask"], dtype=np.int32)
        return ids


class WanTextEncoder:
    """Prompts -> umT5 states {"prompt_embeds": [B, text_len, dim]}.

    t5: a `models.t5.T5Encoder` (its device is where the states are
    made); tokenizer_path: the tokenizer's directory (`google/umt5-xxl`
    under a Wan2.1 directory), loaded at the first `tokenize`."""

    def __init__(self, t5, tokenizer_path: Optional[str] = None,
                 text_len: int = 512):
        self.t5 = t5
        self.tokenizer_path = tokenizer_path
        self.text_len = text_len
        self._tokenizer: Optional[HuggingfaceTokenizer] = None

    @property
    def tokenizer(self) -> HuggingfaceTokenizer:
        if self._tokenizer is None:
            if self.tokenizer_path is None:
                raise ValueError("WanTextEncoder has no tokenizer_path: "
                                 "give it one, or call encode_ids")
            self._tokenizer = HuggingfaceTokenizer(
                self.tokenizer_path, seq_len=self.text_len,
                clean="whitespace")
        return self._tokenizer

    def tokenize(self, text_prompts: Sequence[str]):
        """(ids, mask), int32 numpy [B, text_len]."""
        return self.tokenizer(list(text_prompts), return_mask=True,
                              add_special_tokens=True)

    def encode_ids(self, ids, mask) -> torch.Tensor:
        """ids, mask [B, L] (numpy or tensors) -> states [B, L, dim] on the
        encoder's device."""
        device = self.t5.token_embedding.weight.device
        return self.t5(torch.as_tensor(ids, device=device),
                       torch.as_tensor(mask, device=device))

    def __call__(self, text_prompts: Sequence[str]) -> dict:
        return {"prompt_embeds": self.encode_ids(*self.tokenize(
            text_prompts))}
