"""`mmpl_tpu_torch.tools.flash_compare` off the card: which scale a
baseline checkout's K1 takes, which dKV signature its backward has, which
masked signatures (with or without the coarse tile table) its K4, K5
and K6 have, which P2 and Q signatures its int8 source has, what it refuses, and
that it needs the card (its builds and times run only there)."""

import pytest
import torch

from mmpl_tpu_torch.ops import _build
from mmpl_tpu_torch.tools import flash_compare


def _checkout(root, *names):
    csrc = root / "mmpl_tpu_torch" / "csrc"
    csrc.mkdir(parents=True)
    for name in names:
        (csrc / name).write_text("// source\n")
    return root


@pytest.mark.parametrize("names,log2e", [
    (("flash_fwd.cu", "flash_common.cuh"), False),
    (("flash_fwd.cu", "flash_common.cuh", "flash_fwd_sm90.cuh"), True),
])
def test_baseline_scale_follows_its_sources(tmp_path, names, log2e):
    assert flash_compare.baseline_takes_log2e(
        _checkout(tmp_path, *names)) is log2e


def test_baseline_without_the_forward_source_is_refused(tmp_path):
    with pytest.raises(FileNotFoundError):
        flash_compare.baseline_takes_log2e(_checkout(tmp_path, "x.cuh"))


def test_compare_needs_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = flash_compare.parse_args(["--baseline", str(tmp_path),
                                     "--shapes", "cross"])
    with pytest.raises(RuntimeError, match="CUDA"):
        flash_compare.run(args)


@pytest.mark.parametrize("argv,kernel,shapes", [
    ([], "fwd", list(flash_compare.SHAPES)),
    (["--kernel", "bwd"], "bwd", ["tf_cross", "fewstep_self_hot"]),
    (["--kernel", "bwd", "--shapes", "tf_cross"], "bwd", ["tf_cross"]),
    (["--kernel", "int8"], "int8",
     ["g23_fc1", "g23_fc2", "g0_o", "vae_96ch"]),
    (["--kernel", "masked"], "masked", ["tf_self"]),
])
def test_kernel_choice_parses_with_its_shapes(tmp_path, argv, kernel, shapes):
    args = flash_compare.parse_args(["--baseline", str(tmp_path), *argv])
    assert args.kernel == kernel and args.shapes == shapes


def test_a_shape_of_the_other_kernel_is_refused(tmp_path):
    with pytest.raises(SystemExit):
        flash_compare.parse_args(["--baseline", str(tmp_path), "--kernel",
                                  "bwd", "--shapes", "cross"])


@pytest.mark.parametrize("hopper,dkv_args", [(False, 14), (True, 16)])
def test_baseline_backward_is_bound_by_its_sources(tmp_path, hopper, dkv_args):
    """A baseline without flash_bwd_sm90.cuh has the dKV entry of the
    earlier trees (no workspace, no split); a newer one this tree's."""
    names = ["flash_bwd.cu", "flash_common.cuh"] + (
        ["flash_bwd_sm90.cuh"] if hopper else [])
    root = _checkout(tmp_path, *names)
    sigs = flash_compare.baseline_signatures(root, "flash_bwd")
    dkv = sigs["mmpl_flash_bwd_dkv"]
    assert len(dkv) == dkv_args + 3
    new = _build.SIGNATURES["flash_bwd"]["mmpl_flash_bwd_dkv"]
    assert (dkv == new) is hopper
    assert (dkv == flash_compare.OLD_DKV_SIGNATURE) is (not hopper)
    assert sigs["mmpl_flash_bwd_dq"] == \
        _build.SIGNATURES["flash_bwd"]["mmpl_flash_bwd_dq"]


def test_backward_compare_needs_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = flash_compare.parse_args(["--baseline", str(tmp_path),
                                     "--kernel", "bwd"])
    with pytest.raises(RuntimeError, match="CUDA"):
        flash_compare.run(args)


@pytest.mark.parametrize("hopper", [False, True])
def test_baseline_int8_is_bound_by_its_sources(tmp_path, hopper):
    """A baseline without int8_gemm_sm90.cuh has the entries of the
    `mma.sync` P2 (no tile width, no Q layout); a newer one this tree's."""
    names = ["int8_gemm.cu", "flash_common.cuh"] + (
        ["int8_gemm_sm90.cuh"] if hopper else [])
    root = _checkout(tmp_path, *names)
    assert flash_compare.baseline_has_hopper_int8(root) is hopper
    sigs = flash_compare.baseline_signatures(root, "int8_gemm")
    mine = _build.SIGNATURES["int8_gemm"]
    assert (sigs == mine) is hopper
    assert (sigs == flash_compare.OLD_INT8_SIGNATURES) is (not hopper)
    for fn in mine:     # the new entries take one int more, before the stream
        assert len(mine[fn]) == len(flash_compare.OLD_INT8_SIGNATURES[fn]) + 1


def test_int8_compare_needs_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = flash_compare.parse_args(["--baseline", str(tmp_path),
                                     "--kernel", "int8"])
    with pytest.raises(RuntimeError, match="CUDA"):
        flash_compare.run(args)


#: the K4 and K5 entries' first lines in the trees before and after the
#: coarse tile table
OLD_K4_ENTRY = """extern "C" int mmpl_flash_masked_fwd(int dtype,
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* qf, const void* kf, const void* fm, const void* tiles,
    int F, int B,"""
NEW_K4_ENTRY = """extern "C" int mmpl_flash_masked_fwd(int dtype,
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* qf, const void* kf, const void* fm, const void* tiles,
    const void* coarse, int F, int B,"""
OLD_K5_ENTRY = """extern "C" int mmpl_flash_masked_bwd_dkv(int dtype,
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, const void* qf,
    const void* kf, const void* fm, const void* tiles, int F, int B,"""
NEW_K5_ENTRY = """extern "C" int mmpl_flash_masked_bwd_dkv(int dtype,
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, const void* qf,
    const void* kf, const void* fm, const void* tiles, const void* coarse,
    int F, int B,"""


@pytest.mark.parametrize("coarse", [False, True])
def test_baseline_masked_entries_are_bound_by_their_sources(tmp_path, coarse):
    """A baseline whose K4 entry takes no coarse table (the trees before the
    Hopper K4 and K5) has the older K4 and K5 signatures, one pointer
    shorter; K6's entry takes none in either (the trees before the Hopper
    K6), so it has the older K6 signature in both."""
    root = _checkout(tmp_path, "flash_fwd.cu", "flash_bwd.cu",
                     "flash_common.cuh", "flash_fwd_sm90.cuh",
                     "flash_bwd_sm90.cuh")
    csrc = root / "mmpl_tpu_torch" / "csrc"
    (csrc / "flash_fwd.cu").write_text(NEW_K4_ENTRY if coarse
                                       else OLD_K4_ENTRY)
    (csrc / "flash_bwd.cu").write_text(NEW_K5_ENTRY if coarse
                                       else OLD_K5_ENTRY)
    for source in ("flash_fwd", "flash_bwd"):
        assert flash_compare.baseline_takes_coarse_tables(
            root, source) is coarse
    fwd = flash_compare.baseline_signatures(root, "flash_fwd")
    bwd = flash_compare.baseline_signatures(root, "flash_bwd")
    mine = {**_build.SIGNATURES["flash_fwd"], **_build.SIGNATURES["flash_bwd"]}
    for name in ("mmpl_flash_masked_fwd", "mmpl_flash_masked_bwd_dkv"):
        got = fwd.get(name) or bwd[name]
        assert (got == mine[name]) is coarse
        assert len(got) == len(mine[name]) - (not coarse)
    assert bwd["mmpl_flash_masked_bwd_dq"] == \
        flash_compare.OLD_MASKED_SIGNATURES["mmpl_flash_masked_bwd_dq"]
    assert len(bwd["mmpl_flash_masked_bwd_dq"]) == \
        len(mine["mmpl_flash_masked_bwd_dq"]) - 1
    assert fwd["mmpl_flash_fwd"] == mine["mmpl_flash_fwd"]


#: the K6 entry's first lines in the trees with the Hopper K6
NEW_K6_ENTRY = """extern "C" int mmpl_flash_masked_bwd_dq(int dtype,
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const void* qf,
    const void* kf, const void* fm, const void* tiles, const void* coarse,
    int F, int B,"""


def test_baseline_with_the_hopper_k6_binds_its_coarse_table(tmp_path):
    """A baseline whose K6 entry takes the coarse table (a tree with the
    Hopper K6) has this tree's K4-K6 signatures."""
    root = _checkout(tmp_path, "flash_fwd.cu", "flash_bwd.cu",
                     "flash_common.cuh", "flash_fwd_sm90.cuh",
                     "flash_bwd_sm90.cuh")
    csrc = root / "mmpl_tpu_torch" / "csrc"
    (csrc / "flash_fwd.cu").write_text(NEW_K4_ENTRY)
    (csrc / "flash_bwd.cu").write_text(NEW_K5_ENTRY + "\n" + NEW_K6_ENTRY)
    assert flash_compare.baseline_takes_coarse_tables(root, "flash_bwd", "dq")
    for source in ("flash_fwd", "flash_bwd"):
        assert flash_compare.baseline_signatures(root, source) == {
            n: sig for n, sig in _build.SIGNATURES[source].items()
            if n != "mmpl_flash_exp2"}


def test_masked_compare_needs_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = flash_compare.parse_args(["--baseline", str(tmp_path),
                                     "--kernel", "masked"])
    with pytest.raises(RuntimeError, match="CUDA"):
        flash_compare.run(args)
