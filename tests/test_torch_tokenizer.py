"""Port parity: Wan's text cleaning, the tokenizer wrapper and the text
encoder from strings to states (mmpl_tpu_torch vs mmpl_tpu).  The tokenizer
is a word-level one built in memory with `tokenizers` and saved to
`tmp_path` in the layout `AutoTokenizer.from_pretrained` reads; nothing is
fetched."""

import json

import jax
import numpy as np
import pytest
import torch

from mmpl_tpu.models import t5 as jt5
from mmpl_tpu.utils import tokenizer as jtok
from mmpl_tpu_torch.models import t5 as tt5
from mmpl_tpu_torch.utils import tokenizer as ttok
from mmpl_tpu_torch.utils.jax_params import t5_state_from_jax

WORDS = ("a cat dog surfing wave at sunset on the beach red blue green "
         "quickly slowly runs jumps over fox lazy & < > quote").split()


def save_word_tokenizer(path, words=WORDS):
    """A umT5-like tokenizer in `path`: <pad> = 0, </s> = 1 appended to
    every sequence, <unk> = 2, then one id per word, split on whitespace
    and punctuation."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors
    vocab = {w: i for i, w in enumerate(["<pad>", "</s>", "<unk>", *words])}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(
        single="$A </s>", special_tokens=[("</s>", 1)])
    path.mkdir(parents=True, exist_ok=True)
    tok.save(str(path / "tokenizer.json"))
    (path / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "pad_token": "<pad>",
        "eos_token": "</s>", "unk_token": "<unk>",
        "model_max_length": 512}))
    return str(path)


STRINGS = [
    "  a  cat\tsurfing \n a wave  ",
    "Red &amp; Blue &amp;lt; green &gt; fox",
    "quickly_runs, over... the LAZY dog!!",
    "&quot;quote&quot; at sunset",
    "",
]


@pytest.mark.parametrize("text", STRINGS)
def test_cleaning_functions_match(text):
    assert ttok.basic_clean(text) == jtok.basic_clean(text)
    assert ttok.whitespace_clean(text) == jtok.whitespace_clean(text)
    assert ttok.canonicalize(text) == jtok.canonicalize(text)
    assert ttok.canonicalize(text, "_") == jtok.canonicalize(text, "_")


def test_cleaning_examples():
    assert ttok.whitespace_clean(ttok.basic_clean(STRINGS[0])) == \
        "a cat surfing a wave"
    assert ttok.basic_clean(STRINGS[1]) == "Red & Blue < green > fox"
    assert ttok.canonicalize(STRINGS[2]) == "quickly runs over the lazy dog"


@pytest.mark.parametrize("clean", [None, "whitespace", "lower",
                                   "canonicalize"])
@pytest.mark.parametrize("seq_len", [None, 6, 12])
def test_tokenizer_wrapper_matches(tmp_path, clean, seq_len):
    path = save_word_tokenizer(tmp_path / "tok")
    want = jtok.HuggingfaceTokenizer(path, seq_len=seq_len, clean=clean)
    got = ttok.HuggingfaceTokenizer(path, seq_len=seq_len, clean=clean)
    assert got.vocab_size == want.vocab_size == len(WORDS) + 3
    prompts = STRINGS[:4] if seq_len else STRINGS[:1]
    wi, wm = want(prompts, return_mask=True)
    gi, gm = got(prompts, return_mask=True)
    assert gi.dtype == gm.dtype == np.int32
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gm, wm)
    np.testing.assert_array_equal(got(prompts[0]), want(prompts[0]))


def test_padding_truncation_and_mask(tmp_path):
    tok = ttok.HuggingfaceTokenizer(save_word_tokenizer(tmp_path / "tok"),
                                    seq_len=6, clean="whitespace")
    ids, mask = tok(["a  cat", "a cat surfing a wave at sunset"],
                    return_mask=True)
    cat, a = 3 + WORDS.index("cat"), 3 + WORDS.index("a")
    # "a cat" + </s>, then <pad>
    np.testing.assert_array_equal(ids[0], [a, cat, 1, 0, 0, 0])
    np.testing.assert_array_equal(mask[0], [1, 1, 1, 0, 0, 0])
    # truncated to 6 with </s> kept last
    assert ids[1, -1] == 1 and mask[1].all()


def test_text_encoder_strings_to_states(tmp_path):
    """Strings -> ids -> states: the port's WanTextEncoder against the JAX
    package's on the same tokenizer and TINY_T5 weights (f32, within
    1e-5); the padded positions are 0; encode_ids alone gives the same
    states."""
    path = save_word_tokenizer(tmp_path / "tok")
    cfg = jt5.TINY_T5
    tree = jax.tree.map(np.asarray,
                        jt5.init_t5_params(jax.random.PRNGKey(1), cfg))
    model = tt5.empty_t5(cfg)
    model.load_state_dict(t5_state_from_jax(tree))
    prompts = ["a cat surfing a wave at sunset", "the  lazy dog &amp; fox"]
    want = np.asarray(jtok.WanTextEncoder(tree, cfg, path, text_len=16)(
        prompts)["prompt_embeds"])
    enc = ttok.WanTextEncoder(model, path, text_len=16)
    got = enc(prompts)["prompt_embeds"]
    assert got.shape == want.shape == (2, 16, cfg["dim"])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    ids, mask = enc.tokenize(prompts)
    assert mask[0].sum() == 8 and mask[1].sum() == 6
    np.testing.assert_array_equal(got.numpy()[mask == 0], 0.0)
    torch.testing.assert_close(enc.encode_ids(ids, mask), got, atol=0,
                               rtol=0)
    torch.testing.assert_close(
        enc.encode_ids(torch.from_numpy(ids), torch.from_numpy(mask)), got,
        atol=0, rtol=0)


def test_encode_ids_needs_no_tokenizer():
    model = tt5.init_t5_params(tt5.TINY_T5, torch.Generator().manual_seed(0))
    enc = ttok.WanTextEncoder(model)
    ids = np.array([[5, 6, 1, 0]], np.int32)
    out = enc.encode_ids(ids, (ids > 0).astype(np.int32))
    assert out.shape == (1, 4, 64) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="no tokenizer_path"):
        enc.tokenize(["a cat"])
