"""Port parity: K1's plain version against the Pallas kernel (interpret
mode), the CPU dispatch, and the port's import isolation."""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu.ops.attention import (dense_attention as j_dense,
                                    flash_attention as j_flash,
                                    flash_attention_lse as j_flash_lse)
from mmpl_tpu_torch.ops import attention as ta

SHAPES = [(16, 16), (130, 200), (256, 512), (100, 1000)]
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _qkv(lq, lk, d, seed=0, B=2, N=3):
    rng = np.random.default_rng(seed)
    mk = lambda L: rng.standard_normal((B, L, N, d)).astype(np.float32)
    return mk(lq), mk(lk), mk(lk)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("lq,lk", SHAPES)
def test_plain_matches_pallas_flash(lq, lk, d):
    q, k, v = _qkv(lq, lk, d)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              block_q=128, block_k=128, interpret=True))
    got, _ = ta.flash_attention_plain(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("lq,lk", SHAPES)
def test_plain_lse_matches_pallas_flash_lse(lq, lk, d):
    q, k, v = _qkv(lq, lk, d, seed=1)
    want_o, want_lse = j_flash_lse(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), block_q=128, block_k=128,
                                   interpret=True)
    got_o, got_lse = ta.flash_attention_plain(*map(torch.from_numpy,
                                                   (q, k, v)))
    assert got_lse.shape == (2, 3, lq) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=2e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=1e-5)


def test_plain_chunks_rows_without_changing_the_result(monkeypatch):
    q, k, v = map(torch.from_numpy, _qkv(300, 70, 32, seed=2))
    whole = ta.flash_attention_plain(q, k, v)
    # 4 bytes * B(2) * N(3) * Lk(70) * 7 rows -> chunks of 7 query rows
    monkeypatch.setattr(ta, "_PLAIN_SCORE_BYTES", 4 * 2 * 3 * 70 * 7)
    chunked = ta.flash_attention_plain(q, k, v)
    torch.testing.assert_close(chunked[0], whole[0], atol=1e-6, rtol=0)
    torch.testing.assert_close(chunked[1], whole[1], atol=1e-6, rtol=0)


def test_dense_attention_with_mask_matches():
    q, k, v = _qkv(24, 40, 16, seed=3, B=1, N=2)
    mask = np.random.default_rng(4).random((1, 1, 24, 40)) > 0.3
    mask[..., 0] = True
    want = np.asarray(j_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              mask=jnp.asarray(mask)))
    got = ta.attention(*map(torch.from_numpy, (q, k, v)),
                       mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_cpu_dispatch_runs_plain_and_counts_no_launch():
    ta.reset_launch_counts()
    q, k, v = map(torch.from_numpy, _qkv(33, 65, 24, seed=5))
    out = ta.attention(q, k, v)
    torch.testing.assert_close(out, ta.flash_attention_plain(q, k, v)[0])
    assert set(ta.launch_counts.values()) == {0}


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = map(torch.from_numpy, _qkv(8, 8, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ta.flash_fwd_cuda(q, k, v)
    assert ta.launch_counts["flash_fwd"] == 0


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix()
     for p in (ROOT / "mmpl_tpu_torch").rglob("*.py")]
    + ["chip_smoke.py"]))
def test_port_never_imports_jax_or_the_jax_package(path):
    for mod in _imports(ROOT / path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "mmpl_tpu", "flax"), (path, mod)

