"""Port parity: XLM-RoBERTa, the CLIP text tower
(mmpl_tpu_torch.models.xlm_roberta vs mmpl_tpu.models.xlm_roberta), f32 on
the CPU at a tiny width, with ragged padding.  Tolerances: 2e-5 abs for the
forwards (as test_torch_dit.py), 0 for the conversions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu.models import xlm_roberta as jx
from mmpl_tpu_torch.models import xlm_roberta as tx
from mmpl_tpu_torch.utils.jax_params import (xlm_roberta_head_state_from_jax,
                                             xlm_roberta_state_from_jax)
from test_torch_clip import OUT_DIM, TEXT, synthetic_clip_sd

ATOL = 2e-5
#: ragged rows: padding (pad_id 1) after the end token, at two lengths
IDS = np.array([[0, 5, 9, 23, 2, 1, 1, 1],
                [0, 40, 2, 1, 1, 1, 1, 1],
                [0, 7, 3, 11, 60, 12, 8, 2]], np.int32)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    tree = jax.tree.map(np.asarray, jx.init_xlm_roberta_params(k1, TEXT))
    # non-trivial norms and biases
    tree = jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.05 * rng.standard_normal(a.shape).astype(a.dtype)
        if jax.tree_util.keystr(p).endswith(("'bias']", "'weight']"))
        else a, tree)
    head = jax.tree.map(np.asarray, jx.init_xlm_roberta_head_params(
        k2, TEXT["dim"], OUT_DIM))
    model = tx.XLMRoberta(TEXT, device="meta").to_empty(device="cpu")
    model.load_state_dict(xlm_roberta_state_from_jax(tree, TEXT))
    thead = tx.XLMRobertaHead(TEXT["dim"], OUT_DIM)
    thead.load_state_dict(xlm_roberta_head_state_from_jax(head))
    return tree, head, model, thead


def test_encode_matches(models):
    tree, _, model, _ = models
    want = jx.xlm_roberta_encode(jax.tree.map(jnp.asarray, tree),
                                 jnp.asarray(IDS), TEXT)
    got = tx.xlm_roberta_encode(model, torch.from_numpy(IDS), TEXT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=1e-5)


def test_with_head_and_pool_match(models):
    tree, head, model, thead = models
    jt = jax.tree.map(jnp.asarray, tree)
    want = jx.xlm_roberta_with_head(jt, jax.tree.map(jnp.asarray, head),
                                    jnp.asarray(IDS), TEXT)
    got = tx.xlm_roberta_with_head(model, thead, torch.from_numpy(IDS),
                                   TEXT)
    assert got.shape == (3, OUT_DIM)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=1e-5)
    states = np.random.default_rng(2).standard_normal(
        (3, IDS.shape[1], 5)).astype(np.float32)
    np.testing.assert_allclose(
        tx.masked_mean_pool(torch.from_numpy(states),
                            torch.from_numpy(IDS)).numpy(),
        np.asarray(jx.masked_mean_pool(jnp.asarray(states),
                                       jnp.asarray(IDS))), atol=1e-6)


def test_init_has_the_jax_leaves(models):
    tree, head, _, _ = models
    model = tx.init_xlm_roberta_params(TEXT, torch.Generator().manual_seed(0))
    want = xlm_roberta_state_from_jax(tree, TEXT)
    got = model.state_dict()
    assert set(got) == set(want)
    assert all(got[k].shape == want[k].shape for k in want)
    h = tx.init_xlm_roberta_head_params(TEXT["dim"], OUT_DIM,
                                        torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in h.state_dict().items()} == {
        k: v.shape for k, v in xlm_roberta_head_state_from_jax(head).items()}


@pytest.mark.parametrize("prefixed", [False, True])
def test_convert_and_load_equal_the_bridged_jax_conversion(tmp_path,
                                                           prefixed):
    """The text tower of the whole CLIP dict (keys under `textual.`) and
    of a bare XLMRobertaWithHead dict; `load_xlm_roberta_text` of the
    file equals the conversion, bit for bit."""
    sd = {k: v for k, v in synthetic_clip_sd(seed=2).items()
          if k.startswith("textual.")}
    if not prefixed:
        sd = {k[len("textual."):]: v for k, v in sd.items()}
    jp, jh = jx.convert_xlm_roberta_text(sd, TEXT)
    want = xlm_roberta_state_from_jax(jax.tree.map(np.asarray, jp), TEXT)
    want_h = xlm_roberta_head_state_from_jax(jax.tree.map(np.asarray, jh))
    tsd = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    got, got_h = tx.convert_xlm_roberta_text(tsd, TEXT)
    path = str(tmp_path / "text.pth")
    torch.save(tsd, path)
    model, head = tx.load_xlm_roberta_text(path, TEXT)
    for a, b in ((got, want), (got_h, want_h), (model.state_dict(), want),
                 (head.state_dict(), want_h)):
        assert set(a) == set(b)
        for k in b:
            assert torch.equal(a[k], b[k]), k
