"""`mmpl_tpu_torch.tools.flash_compare` off the card: which scale a
baseline checkout's K1 takes, which dKV signature its backward has, which
masked signatures (with or without the coarse tile table) its K4, K5
and K6 have, which P2 and Q signatures its int8 source has, how P1's entry
is bound, what it refuses, and that it needs the card (its builds and
times run only there)."""

import pathlib
import types

import pytest
import torch

from mmpl_tpu_torch.ops import _build
from mmpl_tpu_torch.ops import attention as ta
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


def test_the_compare_times_every_short_k1_row():
    """The rows where the parent's K1 trailed SDPA, the main path's groups
    and the long rows whose time must hold are all in `SHAPES`."""
    for label in ("group0_self", "group1_self", "group2_self", "group3_self",
                  "i2v_group0_self", "cross", "fewstep_self_hot",
                  "fewstep_cross", "tf_cross", "i2v14b_self", "i2v14b_cross",
                  "i2v14b_img", "clip_self", "bidir_self", "critic_self",
                  "cd_block_self", "gan_head_q1"):
        assert label in flash_compare.SHAPES
    assert flash_compare.SHAPES["gan_head_q1"] == (2, 12, 128, 1, 32760)
    assert flash_compare.SHAPES["clip_self"] == (1, 16, 80, 257, 257)


@pytest.mark.parametrize("argv,kernel,shapes", [
    ([], "fwd", list(flash_compare.SHAPES)),
    (["--shapes", "gan_head_q1", "i2v14b_img"], "fwd",
     ["gan_head_q1", "i2v14b_img"]),
    (["--kernel", "bwd"], "bwd", ["tf_cross", "fewstep_self_hot",
                                  "gan_head_q1", "score_cross",
                                  "critic_self", "ragged", "d24_bf16",
                                  "ring_chunk", "keys896", "heads8_4096",
                                  "heads4_4096"]),
    (["--kernel", "bwd", "--shapes", "tf_cross"], "bwd", ["tf_cross"]),
    (["--kernel", "int8"], "int8",
     ["g23_fc1", "g23_fc2", "g0_o", "vae_96ch"]),
    (["--kernel", "masked"], "masked", ["tf_self"]),
    (["--dtype", "float32"], "fwd", list(flash_compare.F32_SHAPES)),
    (["--kernel", "bwd", "--dtype", "float32", "--shapes", "critic_self"],
     "bwd", ["critic_self"]),
    (["--kernel", "masked", "--dtype", "float32"], "masked", ["tf_self"]),
    (["--kernel", "masked", "--dtype", "float16"], "masked", ["tf_self"]),
    (["--kernel", "bwd", "--dtype", "float16", "--shapes", "tf_cross"],
     "bwd", ["tf_cross"]),
    (["--kernel", "exp2"], "exp2", ["probe", "fewstep_hot"]),
    (["--kernel", "exp2", "--dtype", "float32"], "exp2",
     ["d24_f32", "ode_self_1"]),
    (["--kernel", "exp2", "--dtype", "float32", "--shapes", "ode_self_1"],
     "exp2", ["ode_self_1"]),
])
def test_kernel_choice_parses_with_its_shapes(tmp_path, argv, kernel, shapes):
    args = flash_compare.parse_args(["--baseline", str(tmp_path), *argv])
    assert args.kernel == kernel and args.shapes == shapes


@pytest.mark.parametrize("argv", [
    ["--kernel", "bwd", "--shapes", "cross"],
    ["--dtype", "float32", "--shapes", "cross"],
    ["--kernel", "masked", "--dtype", "float32", "--shapes", "critic_self"],
    ["--kernel", "int8", "--dtype", "float32"],
    ["--kernel", "exp2", "--shapes", "tf_self"],
    ["--kernel", "exp2", "--dtype", "float32", "--shapes", "probe"],
    ["--kernel", "exp2", "--dtype", "float16"],
])
def test_a_shape_of_the_other_kernel_is_refused(tmp_path, argv):
    """A shape of another kernel's (or type's) table, fp32 for a kernel
    whose fp32 body is not compared, and fp16 for any but the masked and
    backward kernels."""
    with pytest.raises(SystemExit):
        flash_compare.parse_args(["--baseline", str(tmp_path), *argv])


def test_fp32_bound_is_taken_at_the_tf32_rate():
    """The fp32 bodies' products run at the TF32 tensor-core rate, so an
    fp32 row's bound is its FLOPs at 495 TFLOP/s (or its bytes)."""
    flops, nbytes = 4.0 * 12 * 4680 * 32760 * 128, 1e6
    assert flash_compare._bound_ms(flops, nbytes, torch.float32) == (
        1e3 * flops / flash_compare.PEAK_TF32)
    assert flash_compare._bound_ms(flops, nbytes, torch.bfloat16) == (
        1e3 * flops / flash_compare.PEAK_FLOPS)


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
    `mma.sync` P2 (no tile width, no Q layout); a Hopper one P2's tile
    width and Q's layout, and, where its Q entry takes a mode, this
    tree's entries."""
    names = ["int8_gemm.cu", "flash_common.cuh"] + (
        ["int8_gemm_sm90.cuh"] if hopper else [])
    root = _checkout(tmp_path, *names)
    assert flash_compare.baseline_has_hopper_int8(root) is hopper
    sigs = flash_compare.baseline_signatures(root, "int8_gemm")
    mine = _build.SIGNATURES["int8_gemm"]
    old, hop = (flash_compare.OLD_INT8_SIGNATURES,
                flash_compare.HOPPER_INT8_SIGNATURES)
    assert sigs == (hop if hopper else old) and sigs != mine
    for fn in mine:     # the Hopper entries take one int more, before the stream
        assert len(hop[fn]) == len(old[fn]) + 1
    # this tree's Q takes its mode after the layout; P2 is unchanged
    assert mine["mmpl_int8_gemm"] == hop["mmpl_int8_gemm"]
    assert len(mine["mmpl_quantize_rows"]) == len(
        hop["mmpl_quantize_rows"]) + 1
    if hopper:
        here = pathlib.Path(_build.CSRC) / "int8_gemm.cu"
        (root / "mmpl_tpu_torch" / "csrc" / "int8_gemm.cu").write_text(
            here.read_text())
        assert flash_compare.baseline_q_takes_mode(root)
        assert flash_compare.baseline_signatures(root, "int8_gemm") == mine


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
    Hopper K6) has this tree's K4-K6 signatures (and, without K1's and K2
    / K3's scheduled entries, this tree's other entries but those)."""
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
            if n not in ("mmpl_flash_exp2", "mmpl_flash_fwd_sched",
                         "mmpl_flash_bwd_sched")}


#: the scheduled K1 entry's first line in the trees that have it
SCHED_ENTRY = """extern "C" int mmpl_flash_fwd_sched(const void* packed,
    float scale, void* stream) {"""


@pytest.mark.parametrize("scheduled", [False, True])
def test_baseline_k1_schedules_follow_its_sources(tmp_path, scheduled):
    """A baseline with `mmpl_flash_fwd_sched` is timed through it under
    this tree's schedule (and bound by this tree's signature); one without
    it through `mmpl_flash_fwd` alone."""
    root = _checkout(tmp_path, "flash_fwd.cu", "flash_common.cuh",
                     "flash_fwd_sm90.cuh")
    csrc = root / "mmpl_tpu_torch" / "csrc"
    (csrc / "flash_fwd.cu").write_text(
        NEW_K4_ENTRY + ("\n" + SCHED_ENTRY if scheduled else ""))
    assert flash_compare.baseline_schedules_k1(root) is scheduled
    sigs = flash_compare.baseline_signatures(root, "flash_fwd")
    assert ("mmpl_flash_fwd_sched" in sigs) is scheduled
    if scheduled:
        assert sigs["mmpl_flash_fwd_sched"] == \
            _build.SIGNATURES["flash_fwd"]["mmpl_flash_fwd_sched"]


#: the scheduled K2 / K3 entry's first line in the trees that have it
BWD_SCHED_ENTRY = """extern "C" int mmpl_flash_bwd_sched(const void* packed,
    float scale, void* stream) {"""


@pytest.mark.parametrize("scheduled", [False, True])
def test_baseline_bwd_schedules_follow_its_sources(tmp_path, scheduled):
    """A baseline with `mmpl_flash_bwd_sched` is timed through it under
    this tree's schedule (and bound by this tree's signature); one without
    it through `mmpl_flash_bwd_dkv` and `mmpl_flash_bwd_dq`."""
    root = _checkout(tmp_path, "flash_bwd.cu", "flash_common.cuh",
                     "flash_bwd_sm90.cuh")
    csrc = root / "mmpl_tpu_torch" / "csrc"
    (csrc / "flash_bwd.cu").write_text(
        NEW_K5_ENTRY + ("\n" + BWD_SCHED_ENTRY if scheduled else ""))
    assert flash_compare.baseline_schedules_bwd(root) is scheduled
    sigs = flash_compare.baseline_signatures(root, "flash_bwd")
    assert ("mmpl_flash_bwd_sched" in sigs) is scheduled
    assert {"mmpl_flash_bwd_dkv", "mmpl_flash_bwd_dq"} <= set(sigs)
    if scheduled:
        assert sigs["mmpl_flash_bwd_sched"] == \
            _build.SIGNATURES["flash_bwd"]["mmpl_flash_bwd_sched"]


def test_the_backward_compare_times_the_schedules_rows():
    """The GAN head's one query row (fused), the 512-key cross-attention
    (K3's persistent walk), the long rows, the ring's chunk and 7 key
    blocks (the ordered walk) and the tiny head dim and 8 and 4 heads over
    4096 keys (the grid) are all in `BWD_SHAPES`; fp32 times the GAN
    head's row too."""
    assert flash_compare.BWD_SHAPES["gan_head_q1"] == (2, 12, 128, 1, 32760)
    assert flash_compare.BWD_SHAPES["score_cross"] == (1, 12, 128, 32760, 512)
    assert flash_compare.BWD_SHAPES["critic_self"] == (
        1, 12, 128, 32760, 32760)
    assert flash_compare.F32_SHAPES["gan_head_q1"] == (2, 12, 128, 1, 32760)
    modes = {label: ta.bwd_schedule(B, N, lq, lk, D, 132)
             for label, (B, N, D, lq, lk) in flash_compare.BWD_SHAPES.items()}
    assert modes == {"tf_cross": "persistent", "fewstep_self_hot": "ordered",
                     "gan_head_q1": "fused", "score_cross": "persistent",
                     "critic_self": "ordered", "ragged": "ordered",
                     "d24_bf16": "grid", "ring_chunk": "ordered",
                     "keys896": "ordered", "heads8_4096": "grid",
                     "heads4_4096": "grid"}


def test_masked_compare_needs_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = flash_compare.parse_args(["--baseline", str(tmp_path),
                                     "--kernel", "masked"])
    with pytest.raises(RuntimeError, match="CUDA"):
        flash_compare.run(args)


def test_exp2_compare_needs_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = flash_compare.parse_args(["--baseline", str(tmp_path),
                                     "--kernel", "exp2", "--dtype",
                                     "float32"])
    with pytest.raises(RuntimeError, match="CUDA"):
        flash_compare.run(args)


def test_exp2_entry_is_bound_by_this_trees_signature():
    """Both trees' P1 entries are bound by this tree's C signature (kept
    since P1), and the variants are P1's four: exp or exp2, with or
    without the pad test."""
    lib = types.SimpleNamespace(mmpl_flash_exp2=types.SimpleNamespace())
    flash_compare.bind_exp2(lib)
    assert lib.mmpl_flash_exp2.argtypes == \
        _build.SIGNATURES["flash_fwd"]["mmpl_flash_exp2"]
    assert {(e, m) for _, e, m in flash_compare.EXP2_VARIANTS} == {
        (False, True), (False, False), (True, True), (True, False)}
    # the probe's shape and the tiny fp32 one run all four; the few-step
    # and ode_self_1 shapes' Lk is ragged for the 64-key tile, so only the
    # variants with the pad test run there
    lk = {name: shape[-1] for name, shape in
          {**flash_compare.EXP2_SHAPES,
           **flash_compare.EXP2_F32_SHAPES}.items()}
    assert {n for n, k in lk.items() if k % 64} == {"fewstep_hot",
                                                    "ode_self_1"}
