"""Token/frame geometry and the macro-from-micro (MMPL) t2v chunk plan.

Port of `mmpl_tpu/core/geometry.py`.  The plan is static Python data:
which frames each chunk-group denoises, which KV-cache slots they occupy
and which cached frames each group attends to.

Constants (reference `casual_fps_inference.py` / `causal_fps_model.py`):
  - 1560 tokens per latent frame at 480x832;
  - 21 latent frames per window = 32760 tokens;
  - KV cache = 15 frame slots; frames >= 19 are stored at slot (frame - 6);
  - a group containing frame 15 runs in "append" mode: its K/V is never
    written; it attends to the visible cache plus its own keys;
  - t2v plan clean_steps=[0,0,1,1,2,2,2,2,2,2,1,1,1,3,3,3,3,3,3,1,1],
    groups [2,7,6,6]; frames {19,20} are hidden from group 2 and visible
    again for group 3;
  - i2v plan clean_steps=[0,1,2,2,3,3,3,3,3,3,2,2,2,4,4,4,4,4,4,2,2],
    groups [1,1,7,6,6]: frame 0 (the encoded image) has a group of its own;
    no visibility toggles, no re-seeds.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

VAE_STRIDE = (4, 8, 8)
PATCH_SIZE = (1, 2, 2)
WINDOW_FRAMES = 21
UNCACHED_FRAMES = 6
REMAP_FRAME = 19
APPEND_TRIGGER_FRAME = 15


def tokens_per_frame(height: int = 480, width: int = 832,
                     vae_stride: Tuple[int, int, int] = VAE_STRIDE,
                     patch_size: Tuple[int, int, int] = PATCH_SIZE) -> int:
    """Tokens per latent frame. 480x832 -> (480/8/2)*(832/8/2) = 30*52 = 1560."""
    lat_h = height // vae_stride[1]
    lat_w = width // vae_stride[2]
    assert lat_h % patch_size[1] == 0 and lat_w % patch_size[2] == 0
    return (lat_h // patch_size[1]) * (lat_w // patch_size[2])


TOKENS_PER_FRAME = tokens_per_frame()            # 1560
WINDOW_TOKENS = WINDOW_FRAMES * TOKENS_PER_FRAME  # 32760
KV_CACHE_SLOTS = WINDOW_FRAMES - UNCACHED_FRAMES  # 15


def pixel_frames(num_latent_frames: int) -> int:
    """Latent frames -> pixel frames under the causal VAE: 21 -> 81."""
    return (num_latent_frames - 1) * VAE_STRIDE[0] + 1


T2V_CLEAN_STEPS: Tuple[int, ...] = (
    0, 0, 1, 1, 2, 2, 2, 2, 2, 2, 1, 1, 1, 3, 3, 3, 3, 3, 3, 1, 1)
#: the i2v variant: the first frame gets a group of its own
I2V_CLEAN_STEPS: Tuple[int, ...] = (
    0, 1, 2, 2, 3, 3, 3, 3, 3, 3, 2, 2, 2, 4, 4, 4, 4, 4, 4, 2, 2)


def cache_slot(frame: int) -> int:
    """KV-cache slot of a window frame."""
    if frame >= REMAP_FRAME:
        return frame - UNCACHED_FRAMES
    if frame >= APPEND_TRIGGER_FRAME:
        raise ValueError(f"frame {frame} is never cached")
    return frame


def groups_from_clean_steps(clean_steps: Sequence[int]) -> List[List[int]]:
    num_groups = max(clean_steps) + 1
    return [[i for i, v in enumerate(clean_steps) if v == g]
            for g in range(num_groups)]


@dataclasses.dataclass(frozen=True)
class GroupSchedule:
    """Static schedule of one chunk-group.

    frames: window frames denoised by the group, ascending.
    append_mode: the group's K/V is never written to the cache.
    write_slots: cache slot per frame (empty in append mode).
    visible_frames / visible_slots: cached frames the group attends to
      after its own write, ascending.
    anchor_group: completion of this group releases the anchors.
    reseed: (position in group, source output frame) pairs re-noised from
      already denoised frames before the group starts.
    """
    index: int
    frames: Tuple[int, ...]
    append_mode: bool
    write_slots: Tuple[int, ...]
    visible_frames: Tuple[int, ...]
    visible_slots: Tuple[int, ...]
    anchor_group: bool
    reseed: Tuple[Tuple[int, int], ...] = ()

    @property
    def num_frames(self) -> int:
        return len(self.frames)

    @property
    def num_visible(self) -> int:
        return len(self.visible_frames)


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    name: str
    clean_steps: Tuple[int, ...]
    groups: Tuple[GroupSchedule, ...]
    anchor_group_index: int
    handoff_frames: Tuple[int, ...]

    @property
    def num_frames(self) -> int:
        return len(self.clean_steps)

    @property
    def group_sizes(self) -> Tuple[int, ...]:
        return tuple(g.num_frames for g in self.groups)


def _build_plan(name: str, clean_steps: Sequence[int], anchor_group: int,
                handoff_frames: Sequence[int],
                vis_toggles: dict, reseeds: dict) -> ChunkPlan:
    """Replay the reference's visibility-set evolution statically."""
    groups = groups_from_clean_steps(clean_steps)
    visible: set = set()
    schedules = []
    for gi, frames in enumerate(groups):
        if gi in vis_toggles:
            op, toggled = vis_toggles[gi]
            if op == "remove":
                visible -= set(toggled)
            else:
                visible |= set(toggled)
        append_mode = APPEND_TRIGGER_FRAME in frames
        if append_mode:
            write_slots: Tuple[int, ...] = ()
        else:
            write_slots = tuple(cache_slot(f) for f in frames)
            visible |= set(frames)
        vis_now = tuple(sorted(visible))
        schedules.append(GroupSchedule(
            index=gi,
            frames=tuple(frames),
            append_mode=append_mode,
            write_slots=write_slots,
            visible_frames=vis_now,
            visible_slots=tuple(cache_slot(f) for f in vis_now),
            anchor_group=(gi == anchor_group),
            reseed=tuple(reseeds.get(gi, ())),
        ))
    return ChunkPlan(name=name, clean_steps=tuple(clean_steps),
                     groups=tuple(schedules),
                     anchor_group_index=anchor_group,
                     handoff_frames=tuple(handoff_frames))


def t2v_plan() -> ChunkPlan:
    """The t2v window plan: groups [2,7,6,6].

    Group 0 = context frames {0,1}; group 1 = anchors {2,3,10,11,12,19,20};
    group 2 = fill {4..9} with {19,20} hidden; group 3 = fill {13..18} with
    {19,20} visible again, in append mode.  Group 2 re-seeds positions 0/5
    from frames 3/10, group 3 from frames 12/19.  Handoff after group 1.
    """
    return _build_plan(
        "t2v",
        T2V_CLEAN_STEPS,
        anchor_group=1,
        handoff_frames=(0, 2, 3, 10, 11, 12, 19, 20),
        vis_toggles={2: ("remove", (19, 20)), 3: ("add", (19, 20))},
        reseeds={2: ((0, 3), (5, 10)), 3: ((0, 12), (5, 19))},
    )


def i2v_plan() -> ChunkPlan:
    """The i2v window plan: groups [1,1,7,6,6].

    Group 0 = frame 0 (the encoded conditioning image, committed clean);
    group 1 = frame 1; group 2 = anchors {2,3,10,11,12,19,20}; groups 3
    and 4 = the fills, group 4 in append mode.  No visibility toggles and
    no re-seeds.  Handoff after group 2: frames (0, 19, 20).
    """
    return _build_plan(
        "i2v",
        I2V_CLEAN_STEPS,
        anchor_group=2,
        handoff_frames=(0, 19, 20),
        vis_toggles={},
        reseeds={},
    )
