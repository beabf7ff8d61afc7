"""Upstream Wan2.1 reference pipelines: whole-clip T2V / I2V generation.

Port of `mmpl_tpu/pipelines/wan_reference.py` (`WanT2V.generate`,
`WanI2V.generate_from_image`), on one device: UniPC with classifier-free
guidance over the bidirectional Wan DiT (`models/dit.dit_forward`), the
cond / uncond pair batched into one forward of batch 2B, every token of
the clip attending every token (K1 at 32,760 x 32,760 for 21 latent
frames at 480x832), then the streaming VAE decode.  I2V adds the CLIP
image tokens (31 blocks of ViT-H/14, their own cross-attention in each
layer) and the channel-concatenated mask and first-frame latents `y`.

With a `mesh` whose `sp` axis has more than one rank, the T2V forward
runs sequence-parallel (`parallel/sequence_parallel.usp_dit_forward`):
Ulysses over `sp`, and the ring over `ring` where the mesh has that axis
with more than one rank, as the JAX package's `_forward` chooses.  Not
ported: the `MMPL_STEPS_PER_PROGRAM` segmentation of the solver loop (a
TPU workaround for long programs; the loop here runs step by step anyway).
`phase_times` holds the last run's seconds: `clip_s`, `encode_s` (i2v),
`steps_s` and `decode_s`, measured after a device synchronise when
`sync_timing` is set.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..models import vae as vae_mod
from ..models.clip import CLIPVisual, clip_visual_forward, preprocess_image
from ..models.dit import WanDiT, dit_forward, fuse_qkv_params
from ..parallel.collectives import as_mesh
from ..parallel.sequence_parallel import usp_dit_forward
from ..schedulers.unipc import FlowUniPC


@torch.inference_mode()
def build_i2v_conditioning(vae_model, image: torch.Tensor,
                           num_frames: int = 21) -> torch.Tensor:
    """The i2v `y`: a 4-channel first-frame mask (frame 0 replicated 4x
    in the temporal packing) concatenated with the VAE latents of [image,
    4 (num_frames - 1) zero frames], encoded in causal chunks
    (`vae.encode_streaming`).

    image: [B, 3, H, W] in [-1, 1].  Returns [B, F, 20, H/8, W/8]."""
    B, _, H, W = image.shape
    lat_h, lat_w = H // 8, W // 8
    T_pix = (num_frames - 1) * 4 + 1
    msk = torch.zeros((B, T_pix + 3, lat_h, lat_w), dtype=torch.float32,
                      device=image.device)
    msk[:, :4] = 1.0
    msk = msk.reshape(B, num_frames, 4, lat_h, lat_w)
    clip_vid = torch.cat([image[:, None], image.new_zeros(
        (B, T_pix - 1, 3, H, W))], dim=1)
    lat = vae_mod.encode_streaming(vae_model, clip_vid)
    return torch.cat([msk, lat.float()], dim=2)


class WanT2V:
    """Whole-clip text-to-video."""

    def __init__(self, cfg, model: WanDiT, vae_model,
                 sampling_steps: int = 50, timestep_shift: float = 5.0,
                 guidance_scale: float = 5.0, mesh=None,
                 dtype=torch.bfloat16):
        self.cfg = cfg
        #: a `parallel/collectives` mesh or a DeviceMesh (sequence
        #: parallelism over its `sp` and `ring` axes), or None
        self.mesh = None if mesh is None else as_mesh(mesh)
        if not model.blocks[0].self_attn.fused:
            fuse_qkv_params(model, num_heads=cfg.num_heads)
        self.model = model
        self.vae = vae_model
        self.guidance_scale = float(guidance_scale)
        self.dtype = dtype
        self.sampler = FlowUniPC(sampling_steps, shift=timestep_shift)
        self.sync_timing = False
        self.phase_times = {}

    def _forward(self, lat2, t2, ctx2, clip2, y2):
        mesh = self.mesh
        if (mesh is not None and "sp" in mesh.names and mesh.size("sp") > 1
                and clip2 is None):
            ring = "ring" if ("ring" in mesh.names
                              and mesh.size("ring") > 1) else None
            return usp_dit_forward(self.model, self.cfg, lat2, t2, ctx2,
                                   mesh, ring_axis=ring)
        return dit_forward(self.model, self.cfg, lat2, t2, ctx2,
                           clip_fea=clip2, y=y2)

    def _clock(self, device) -> float:
        if self.sync_timing and device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    @torch.inference_mode()
    def generate(self, noise: torch.Tensor, cond_context: torch.Tensor,
                 uncond_context: torch.Tensor,
                 clip_fea: Optional[torch.Tensor] = None,
                 y: Optional[torch.Tensor] = None,
                 decode: bool = True) -> torch.Tensor:
        """noise [B, F, 16, h, w]; contexts [B, T, text_dim]; i2v:
        clip_fea [B, 257, 1280] and y [B, F, 20, h, w].  Returns the
        pixels [B, 1 + 4 (F - 1), 3, 8h, 8w] in [-1, 1] (fp32), or the
        latents without `decode`."""
        B = noise.shape[0]
        device = noise.device
        dt = self.dtype
        ctx2 = torch.cat([cond_context, uncond_context], 0).to(dt)
        clip2 = None if clip_fea is None else torch.cat(
            [clip_fea, clip_fea], 0).to(dt)
        y2 = None if y is None else torch.cat([y, y], 0).to(dt)
        state = self.sampler.init_state(noise.float())
        t0 = self._clock(device)
        for coef, t in zip(self.sampler.table, self.sampler.timesteps):
            lat2 = torch.cat([state["sample"], state["sample"]], 0).to(dt)
            t2 = torch.full((2 * B,), float(t), dtype=torch.float32,
                            device=device)
            flow2 = self._forward(lat2, t2, ctx2, clip2, y2)
            c, u = flow2[:B], flow2[B:]
            flow = u.float() + self.guidance_scale * (c - u).float()
            state = self.sampler.step(coef, state, flow)
        t1 = self._clock(device)
        self.phase_times = {"steps_s": t1 - t0}
        latents = state["sample"]
        if not decode:
            return latents
        out = vae_mod.decode_streaming(self.vae, latents.float())
        self.phase_times["decode_s"] = self._clock(device) - t1
        return out


class WanI2V(WanT2V):
    """Whole-clip image-to-video: the CLIP image tokens and the
    channel-concatenated conditioning `y`; needs an i2v DiT (in_dim 36)."""

    def __init__(self, *args, clip_model: Optional[CLIPVisual] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.clip_model = clip_model

    @torch.inference_mode()
    def generate_from_image(self, noise: torch.Tensor, image: torch.Tensor,
                            cond_context: torch.Tensor,
                            uncond_context: torch.Tensor,
                            decode: bool = True) -> torch.Tensor:
        """image [B, 3, H, W] in [-1, 1]; noise [B, F, 16, H/8, W/8]."""
        if self.clip_model is None:
            raise ValueError("WanI2V needs clip_model (models.clip)")
        device = noise.device
        t0 = self._clock(device)
        clip_dtype = self.clip_model.pos_embedding.dtype
        clip_in = preprocess_image(image.float()).to(clip_dtype)
        clip_tokens = clip_visual_forward(self.clip_model, clip_in,
                                          self.clip_model.cfg,
                                          use_31_block=True)
        t1 = self._clock(device)
        y = build_i2v_conditioning(self.vae, image.float(), noise.shape[1])
        t2 = self._clock(device)
        out = self.generate(noise, cond_context, uncond_context,
                            clip_fea=clip_tokens, y=y, decode=decode)
        self.phase_times.update(clip_s=t1 - t0, encode_s=t2 - t1)
        return out
