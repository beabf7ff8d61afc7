"""Port parity: the auxiliary utilities (`mmpl_tpu_torch/utils/misc.py`,
`memory.py`, `profiling.trace` / `device_memory_stats`, `qwen_vl.py`,
`prompt_extend.py`) against the JAX package's, on the CPU.

`qwen_vl`'s sizes are integers and equal JAX's exactly; the expanders
fall back to the prompt as `tests/test_aux.py:289` holds the JAX one
(a closed local port; no other network); the Qwen expander's error path
is taken with `transformers` unimportable."""

import base64
import io
import json
import random
import sys

import numpy as np
import pytest
import torch

from mmpl_tpu.utils import misc as jmisc
from mmpl_tpu.utils import prompt_extend as jpe
from mmpl_tpu.utils import qwen_vl as jqv
from mmpl_tpu_torch.utils import memory as tmem
from mmpl_tpu_torch.utils import misc as tmisc
from mmpl_tpu_torch.utils import profiling as tprof
from mmpl_tpu_torch.utils import prompt_extend as tpe
from mmpl_tpu_torch.utils import qwen_vl as tqv


def test_set_seed_seeds_random_numpy_and_torch():
    draws = []
    for mod in (jmisc, tmisc):
        out = mod.set_seed(7)
        draws.append((random.random(), float(np.random.rand())))
        if mod is tmisc:
            assert isinstance(out, torch.Generator)
            assert out.initial_seed() == 7
            a = torch.rand(3)
            tmisc.set_seed(7)
            assert torch.equal(torch.rand(3), a)
    assert draws[0] == draws[1]


def test_merge_dict_list_matches_jax():
    rng = np.random.default_rng(0)
    steps = [{"x": rng.standard_normal((2, 3)).astype(np.float32),
              "n": i, "s": np.float32(i)} for i in range(3)]
    want = jmisc.merge_dict_list(steps)
    got = tmisc.merge_dict_list(steps)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["x"], np.asarray(want["x"]))
    assert got["n"] == want["n"] == 0 and got["s"] == want["s"]
    tens = tmisc.merge_dict_list([{k: torch.from_numpy(v["x"])}
                                  for k, v in zip("aaa", steps)])
    assert torch.equal(tens["a"], torch.from_numpy(np.array(want["x"])))
    assert tmisc.merge_dict_list([]) == jmisc.merge_dict_list([]) == {}


def test_memory_stats_are_none_on_the_cpu(monkeypatch):
    assert tmem.hbm_bytes_in_use() is None
    assert tmem.free_hbm_gb() is None
    assert tmem.hbm_bytes_in_use("cpu") is None
    assert tprof.device_memory_stats() == {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    # a CPU device is never the card's, even where one is present
    assert tmem.hbm_bytes_in_use("cpu") is None
    assert tprof.device_memory_stats("cpu") == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "tr")) as d:
        torch.matmul(torch.ones(8, 8), torch.ones(8, 8))
    assert d == str(tmp_path / "tr")
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name", "") for e in events["traceEvents"]}
    assert any("matmul" in n or "mm" in n for n in names)


@pytest.mark.parametrize("h,w", [(480, 832), (28, 28), (10, 10),
                                 (4000, 6000), (1, 150), (1080, 1920),
                                 (15000, 15000)])
def test_smart_resize_matches_jax(h, w):
    for fn in ("round_by_factor", "ceil_by_factor", "floor_by_factor"):
        assert getattr(tqv, fn)(h / 3, 28) == getattr(jqv, fn)(h / 3, 28)
    assert tqv.smart_resize(h, w) == jqv.smart_resize(h, w)
    assert tqv.smart_resize(h, w, factor=14, min_pixels=256 * 256,
                            max_pixels=512 * 512) == jqv.smart_resize(
        h, w, factor=14, min_pixels=256 * 256, max_pixels=512 * 512)


def test_smart_resize_refuses_extreme_ratios():
    for mod in (jqv, tqv):
        with pytest.raises(ValueError, match="aspect ratio"):
            mod.smart_resize(1, 300)


def test_fetch_image_and_vision_info_match_jax(tmp_path):
    from PIL import Image
    arr = np.random.default_rng(1).integers(0, 255, (61, 97, 3), np.uint8)
    img = Image.fromarray(arr)
    path = tmp_path / "im.png"
    img.save(path)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    b64 = "data:image/png;base64," + base64.b64encode(
        buf.getvalue()).decode()
    for src in (img, str(path), f"file://{path}", b64, {"image": str(path)}):
        a, b = jqv.fetch_image(src), tqv.fetch_image(src)
        assert a.size == b.size
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    with pytest.raises(TypeError):
        tqv.fetch_image(3)
    msgs = [{"role": "system", "content": "text only"},
            {"role": "user", "content": [{"type": "image", "image":
                                          str(path)},
                                         {"type": "video", "video": "v.mp4"},
                                         {"type": "text", "text": "hi"}]}]
    (ji, jv), (ti, tv) = (m.process_vision_info(msgs) for m in (jqv, tqv))
    assert jv == tv == ["v.mp4"] and len(ji) == len(ti) == 1
    np.testing.assert_array_equal(np.asarray(ti[0]), np.asarray(ji[0]))
    assert tqv.process_vision_info(msgs[:1]) == (None, None)


def test_prompt_expander_system_prompts_match_jax():
    for is_vl in (False, True):
        for lang in ("zh", "en"):
            assert tpe.PromptExpander(is_vl).decide_system_prompt(lang) == \
                jpe.PromptExpander(is_vl).decide_system_prompt(lang)
    assert tpe.PromptOutput(True, "p").seed == -1


def test_prompt_expander_fallback():
    ex = tpe.DashScopePromptExpander(api_key="x",
                                     base_url="http://127.0.0.1:1")
    out = ex("a cat", tar_lang="en")
    assert out.status is False
    assert out.prompt == "a cat"
    assert out.message
    assert out.system_prompt == tpe.LM_EN_SYS_PROMPT


def test_qwen_expander_falls_back_without_transformers(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    ex = tpe.QwenPromptExpander("no-such-model", is_vl=True, device="cpu")
    out = ex("a dog", tar_lang="zh", seed=3)
    assert (out.status, out.prompt, out.seed) == (False, "a dog", 3)
    assert "transformers" in out.message
    assert out.system_prompt == tpe.VL_ZH_SYS_PROMPT
