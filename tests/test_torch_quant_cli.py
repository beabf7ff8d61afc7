"""The port's serving CLI on the CPU with the int8 flags (`--quantize`,
`--quantize-cache`, `--quantize-vae`)."""

import numpy as np
import pytest
import torch

from mmpl_tpu_torch import cli


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs several test workers at once on the CPU; torch's default
    of one thread per core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("flags", [
    ["--quantize", "int8", "--quantize-cache", "--quantize-vae"],
    ["--quantize", "auto"],
    ["--quantize", "int8wo"],
])
def test_cli_cpu_runs_the_int8_flags(monkeypatch, tmp_path, flags):
    """One window each (the plain int8 VAE decode takes ~20 s on the CPU);
    `chip_smoke.py` takes `--quantize auto --quantize-cache --quantize-vae`
    through the bridged second window on the card."""
    from mmpl_tpu_torch.models import vae
    written = {}

    def fake_write(path, frames, fps=16):
        written["frames"] = frames
        return path

    monkeypatch.setattr("mmpl_tpu_torch.utils.video_io.write_video",
                        fake_write)
    vae.int8_conv_counts.update(convs=0, chunks=0)
    rc = cli.main(["--model", "smoke", "--duration", "1",
                   "--sampling-steps", "1", "--device", "cpu", *flags,
                   "--output", str(tmp_path / "out.mp4")])
    assert rc == 0
    frames = written["frames"]
    assert frames.shape == (81, 64, 64, 3)
    assert frames.dtype == np.uint8 and frames.max() > frames.min()
    assert (vae.int8_conv_counts["convs"] > 0) == ("--quantize-vae" in flags)


def test_cli_refuses_an_unknown_quantize_mode(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--model", "smoke", "--device", "cpu", "--quantize", "int4"])
    assert e.value.code == 2
    assert "int8wo" in capsys.readouterr().err
