"""Port parity: the frame-granular training masks (numpy on both sides)."""

import numpy as np
import pytest

from mmpl_tpu.core.geometry import T2V_CLEAN_STEPS
from mmpl_tpu.training import masks as jm
from mmpl_tpu_torch.core.geometry import T2V_CLEAN_STEPS as T_STEPS
from mmpl_tpu_torch.training import masks as tm


@pytest.mark.parametrize("kw", [
    dict(num_frames=6, num_frame_per_block=3),
    dict(num_frames=7, num_frame_per_block=3, independent_first_frame=True),
    dict(num_frames=9, num_frame_per_block=3, local_attn_frames=3),
    dict(num_frames=21, num_frame_per_block=1),
])
def test_blockwise_causal_frame_mask_matches(kw):
    np.testing.assert_array_equal(tm.blockwise_causal_frame_mask(**kw),
                                  jm.blockwise_causal_frame_mask(**kw))


@pytest.mark.parametrize("f,nb", [(6, 3), (21, 3), (5, 1)])
def test_teacher_forcing_frame_mask_matches(f, nb):
    np.testing.assert_array_equal(tm.teacher_forcing_frame_mask(f, nb),
                                  jm.teacher_forcing_frame_mask(f, nb))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(noise_steps=[s + 1 for s in T2V_CLEAN_STEPS]),
    dict(blind_frames=(3,), blind_step=1),
])
def test_fps_forcing_frame_mask_matches(kw):
    assert tuple(T_STEPS) == tuple(T2V_CLEAN_STEPS)
    want = jm.fps_forcing_frame_mask(T2V_CLEAN_STEPS, **kw)
    got = tm.fps_forcing_frame_mask(T_STEPS, **kw)
    assert got.dtype == bool and got.shape == (42, 42)
    np.testing.assert_array_equal(got, want)


def test_expand_frame_mask_matches():
    fm = jm.fps_forcing_frame_mask(T2V_CLEAN_STEPS[:9])
    np.testing.assert_array_equal(tm.expand_frame_mask(fm, 3),
                                  jm.expand_frame_mask(fm, 3))
