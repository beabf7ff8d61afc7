"""`mmpl_tpu_torch.tools.flash_compare` off the card: which scale a
baseline checkout's K1 takes, what it refuses, and that it needs the card
(its builds and times run only there)."""

import pytest
import torch

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
