"""Port parity: P1, the exp2 probe's attention forward
(`tools/exp2_probe.py:_fwd_kernel`), in interpret mode against the port's
plain version `flash_attention_exp2_plain` on the same inputs, for the four
variants (exp / exp2, with / without the pad test); what the wrapper
refuses; and the port's probe on the CPU."""

import functools
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu_torch.ops import attention as ta
from mmpl_tpu_torch.tools import exp2_probe

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def probe():
    """tools/exp2_probe.py, the TPU kernel P1, imported by path."""
    spec = importlib.util.spec_from_file_location(
        "exp2_probe_tpu", ROOT / "tools" / "exp2_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(dtype, seed=0, B=1, Lq=128, Lk=256, N=2, D=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, L, N, D)).astype(np.float32)
            for L in (Lq, Lk, Lk)]


# f32: the order of sums only.  bf16: both round P to bf16 before PV, the
# kernel against its running row max of each 128-key block, the plain
# version against the row's max; O is rounded to bf16 on both sides, so
# they may differ by one bf16 ulp of |O| < 1 (measured: 1.95e-3).
TOL = {"float32": dict(atol=2e-6, rtol=1e-5),
       "bfloat16": dict(atol=4e-3, rtol=0)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_exp2", [False, True])
@pytest.mark.parametrize("mask_pad", [True, False])
def test_plain_matches_the_pallas_kernel(probe, monkeypatch, dtype, use_exp2,
                                         mask_pad):
    monkeypatch.setattr(probe.pl, "pallas_call", functools.partial(
        probe.pl.pallas_call, interpret=True))
    q, k, v = _inputs(dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(probe.variant(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), 64, 128, use_exp2,
        mask_pad).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = ta.flash_attention_exp2(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        use_exp2=use_exp2, mask_pad=mask_pad)
    assert got.dtype == tdt and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])
    assert ta.launch_counts["flash_exp2"] == 0      # CPU: no launch


def test_exp_and_exp2_agree_with_the_plain_k1():
    """In fp32 the four variants are the same function as K1's plain
    version up to the rounding of the folded scale."""
    q, k, v = (torch.from_numpy(a) for a in _inputs("float32", 1, Lq=70,
                                                     Lk=192))
    want = ta.flash_attention_plain(q, k, v)[0]
    for use_exp2 in (False, True):
        for mask_pad in (True, False):
            got = ta.flash_attention_exp2(q, k, v, use_exp2, mask_pad)
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6,
                                       rtol=1e-5)


@pytest.mark.parametrize("Lk", [100, 4680 * 7])
def test_mask_pad_false_refuses_a_ragged_key_length(Lk):
    """Without the pad test the last key tile's padding would count as
    keys; the wrapper refuses rather than drop or add keys silently."""
    q = torch.zeros((1, 4, 1, 8))
    k = torch.zeros((1, Lk, 1, 8))
    with pytest.raises(ValueError, match="mask_pad=False"):
        ta.flash_attention_exp2(q, k, k, mask_pad=False)
    assert ta.flash_attention_exp2(q, k, k, mask_pad=True).shape == q.shape


def test_probe_runs_on_the_cpu(capsys):
    """The port's probe at its tiny shapes with the plain versions: four
    variants at the probe shape, the two legal ones at the hot shape."""
    rows = exp2_probe.run(exp2_probe.parse_args(["--device", "cpu",
                                                 "--tiny"]))
    got = [(r["shape"], r["variant"]) for r in rows]
    assert got[:5] == [("probe", "exp+mask"), ("probe", "exp"),
                       ("probe", "exp2+mask"), ("probe", "exp2"),
                       ("probe", "k1")]
    hot = [v for s, v in got if s == "hot"]
    assert "exp2+mask" in hot and "exp2" not in hot and "exp" not in hot
    assert all(r["max_diff"] <= 2e-2 for r in rows if "max_diff" in r)
    assert "exp2=True mask=True" in capsys.readouterr().err
