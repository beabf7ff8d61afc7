"""Port parity: plan geometry and model configs (mmpl_tpu_torch vs mmpl_tpu)."""

import dataclasses

import pytest

from mmpl_tpu.core import config as jcfg
from mmpl_tpu.core import geometry as jg
from mmpl_tpu_torch.core import config as tcfg
from mmpl_tpu_torch.core import geometry as tg


def test_t2v_plan_matches_field_by_field():
    want, got = jg.t2v_plan(), tg.t2v_plan()
    for field in ("name", "clean_steps", "anchor_group_index",
                  "handoff_frames", "num_frames", "group_sizes"):
        assert getattr(got, field) == getattr(want, field), field
    assert len(got.groups) == len(want.groups) == 4
    for gw, gg in zip(want.groups, got.groups):
        assert dataclasses.asdict(gg) == dataclasses.asdict(gw)
        assert gg.num_visible == gw.num_visible
    assert got.group_sizes == (2, 7, 6, 6)
    assert [g.append_mode for g in got.groups] == [False, False, False, True]


@pytest.mark.parametrize("frame", range(21))
def test_cache_slot_matches(frame):
    try:
        want = jg.cache_slot(frame)
    except ValueError:
        with pytest.raises(ValueError):
            tg.cache_slot(frame)
        return
    assert tg.cache_slot(frame) == want


def test_geometry_constants_match():
    for name in ("VAE_STRIDE", "PATCH_SIZE", "WINDOW_FRAMES",
                 "UNCACHED_FRAMES", "TOKENS_PER_FRAME", "WINDOW_TOKENS",
                 "KV_CACHE_SLOTS"):
        assert getattr(tg, name) == getattr(jg, name), name
    assert tg.tokens_per_frame(480, 832) == jg.tokens_per_frame(480, 832)
    assert tg.pixel_frames(21) == jg.pixel_frames(21) == 81


@pytest.mark.parametrize("name", ["t2v-1.3B", "t2v-14B"])
def test_model_configs_match(name):
    assert dict(tcfg.WAN_CONFIGS[name]) == dict(jcfg.WAN_CONFIGS[name])


def test_tiny_config_matches():
    assert dict(tcfg.tiny_test_config()) == dict(jcfg.tiny_test_config())
