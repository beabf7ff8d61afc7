"""Chunk-pipelined multi-window generation over pipeline stages.

Port of `mmpl_tpu/parallel/chunk_pipeline.py`.  The reference runs one
pipeline replica per GPU, a Python thread per chunk and the filesystem as
the channel between them (the producer saves the anchors mid-generation,
the consumer polls for the file).  Here a stage is a device, a CUDA stream
on it and a `CausalFPSInferencePipeline`; stages on the same device share
one model and one VAE (only each window's KV cache is per stage), so a
device list may name one card several times.  Chunk i runs on stage
i % S, round-robin beyond the stage count.

Each stage has a worker thread that launches its chunks on its own stream:
torch enqueues thousands of kernels a window, and a thread blocks once its
queue of pending launches is full, so one thread walking the chunks in
turn would not have chunk k+1 enqueued while chunk k still runs.  The
anchor handoff is a CUDA event: after the anchor group the producing
stage records it on its stream, and the consuming stage's stream waits on
it (`wait_event`) before the bridge.  No host synchronisation, no files,
no polling; the host only waits until the producer has enqueued the
anchor group.  Tensors used on another stream than the one that made them
are `record_stream`-ed, so the caching allocator cannot hand their memory
out early.

The inter-chunk bridge is the JAX package's causal prefix: decode latent
frames [0:5) of the handoff mask, keep pixel frames 8:13, re-encode, keep
the first two latents (the reference decodes a full 21-frame window and
re-encodes 81 frames for the same two latents).

With `stage_meshes` (JAX's one pipeline per sub-mesh) the stages are
processes: each process belongs to one stage's mesh, builds that stage
only (its model sharded over the sub-mesh, `InferenceSharding`) and runs
the chunks c with c % S equal to its stage.  After the anchor group each
rank sends the anchors, the same on every rank of a stage, to the rank
at its own position in the next stage, without blocking (the sender goes
on with its fill groups); the receiver's stream waits for them before
the bridge (`collectives.DistGroup.send` / `recv` on the default group;
under gloo a CUDA tensor crosses through host memory, the copy and the
send on a thread of their own).

Not ported (TPU workarounds): `MMPL_STEPS_PER_PROGRAM` and the compile
cache.  The JAX `rng` splits become one `torch.Generator` per chunk, or
the reseed draws handed in.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..core.geometry import ChunkPlan, t2v_plan
from ..models import vae as vae_mod
from ..pipelines.fps_inference import CausalFPSInferencePipeline


def make_bridge_fn(vae_model, num_handoff: int):
    """handoff latents [B, n, C, H, W] -> initial latents [B, 2, C, H, W].

    As Wan_fps_inference_parallel_4gpu_20s.py:191-205: mask[0] =
    handoff[0], mask[1] = mask[2] = handoff[-2], mask[3] = handoff[-1];
    decode; pixel frames 8:13 head a blank clip; re-encode; keep the first
    two latents.  The VAE is causal in time, so decoding latent frames
    [0:5) and re-encoding those 5 pixel frames gives the same latents."""

    @torch.inference_mode()
    def bridge(handoff: torch.Tensor) -> torch.Tensor:
        if handoff.shape[1] != num_handoff:
            raise ValueError(f"bridge takes {num_handoff} handoff latents, "
                             f"got {handoff.shape[1]}")
        B, _, C, H, W = handoff.shape
        mask = handoff.new_zeros((B, 5, C, H, W), dtype=torch.float32)
        mask[:, 0] = handoff[:, 0]
        mask[:, 1] = handoff[:, -2]
        mask[:, 2] = handoff[:, -2]
        mask[:, 3] = handoff[:, -1]
        vid = vae_mod.decode(vae_model, mask)              # [-1, 1]
        clip = (vid * 0.5 + 0.5)[:, 8:13] * 2.0 - 1.0      # 5 pixel frames
        return vae_mod.encode(vae_model, clip)[:, :2]

    return bridge


def default_devices() -> List[torch.device]:
    """Every visible card, as the JAX package takes `jax.devices()`."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass devices "
                           "(e.g. [torch.device('cpu')] * 2) to run on the "
                           "CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _canonical(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _device_of(module: torch.nn.Module) -> torch.device:
    return _canonical(next(module.parameters()).device)


@dataclasses.dataclass
class Stage:
    """One pipeline stage: its device, its stream (None on the CPU), its
    pipeline, the VAE and the bridge (shared by the stages of a device)."""
    device: torch.device
    stream: Optional["torch.cuda.Stream"]
    pipe: CausalFPSInferencePipeline
    vae: torch.nn.Module
    bridge: object


class _Handoff:
    """Chunk k's anchors for chunk k+1: set once, by the producer's thread,
    when the anchor group is enqueued (None if the chunk gave none)."""

    def __init__(self):
        self._ready = threading.Event()
        self.latents: Optional[torch.Tensor] = None
        self.event = None           # CUDA event after the anchor group
        self.failed = False
        self.sent = None            # a send in flight (`_PeerHandoff`)

    def set(self, latents, event=None, failed: bool = False) -> None:
        if not self._ready.is_set():
            self.latents, self.event, self.failed = latents, event, failed
            self._ready.set()

    def wait(self) -> "_Handoff":
        self._ready.wait()
        if self.failed:
            raise RuntimeError("the producing chunk failed")
        return self


class _PeerHandoff(_Handoff):
    """The same handoff between processes (stage_meshes): `set`, on chunk
    k's process, sends the anchors to the rank at this rank's position in
    chunk k+1's stage without blocking (`ChunkParallelPipeline._send`);
    `wait`, on chunk k+1's process, receives them from the rank at its
    position in chunk k's stage."""

    def __init__(self, pipe: "ChunkParallelPipeline", ci: int, last: bool,
                 shape, device: torch.device):
        super().__init__()
        self.pipe, self.ci, self.last = pipe, ci, last
        self.shape, self.device = shape, device

    def set(self, latents, event=None, failed: bool = False) -> None:
        if self._ready.is_set():
            return
        self._ready.set()
        if latents is not None and not self.last:
            S = self.pipe.num_stages
            self.sent = self.pipe._send(
                latents, self.pipe.peers[(self.ci + 1) % S], event)

    def wait(self) -> "_Handoff":
        like = torch.empty(self.shape, dtype=torch.float32,
                           device=self.device)
        self.latents = self.pipe._world.recv(
            like, self.pipe.peers[self.ci % self.pipe.num_stages])
        return self


class ChunkParallelPipeline:
    """W chunks pipelined over S stages, each a device and a stream."""

    def __init__(self, cfg, model, vae_model,
                 devices: Optional[Sequence] = None,
                 plan: Optional[ChunkPlan] = None,
                 stage_meshes: Optional[Sequence] = None,
                 **pipe_kwargs):
        """devices: one entry per stage (default: every visible card); a
        device may repeat, and its stages then share one model and VAE.
        stage_meshes: one DeviceMesh per stage (`parallel/mesh.
        make_stage_meshes`, built by every process), in place of
        `devices`: this process runs the stage whose mesh holds its rank,
        on the device of `model`.  pipe_kwargs go to
        `CausalFPSInferencePipeline`."""
        self.plan = plan or t2v_plan()
        n_handoff = len(self.plan.handoff_frames)
        self.stages: List[Stage] = []
        #: per chunk of the last `generate` (this process's chunks only,
        #: with stage_meshes): chunk, stage, host dispatch start / end
        #: (perf_counter, one clock for every process of a host), when the
        #: previous chunk's anchors had reached it (`received`: enqueued
        #: by another stage of this process, or arrived from another
        #: process), the stage pipeline's phase_times and, on a card, its
        #: CUDA events (`device_timeline` reads them); with stage_meshes on
        #: a card, also when its last group had run (`done`)
        self.dispatch_log: List[dict] = []
        #: with stage_meshes: this process's stage, its number of stages
        #: and the global rank at this rank's position in each stage
        self.stage_index, self.num_stages, self.peers = 0, None, None
        if stage_meshes is not None:
            self._own_stage(cfg, model, vae_model, stage_meshes,
                            pipe_kwargs)
            return
        self.devices = [_canonical(d) for d in (
            devices if devices is not None else default_devices())]
        shared: Dict[torch.device, Stage] = {}
        for dev in self.devices:
            if dev in shared:
                first = shared[dev]
                pipe = copy.copy(first.pipe)      # own phase_times
                pipe.phase_times = {}
                self.stages.append(Stage(dev, self._stream(dev), pipe,
                                         first.vae, first.bridge))
                continue
            m = model if _device_of(model) == dev else \
                copy.deepcopy(model).to(dev)
            vm = self._vae_on(vae_model, dev)
            pipe = CausalFPSInferencePipeline(cfg, m, plan=self.plan,
                                              **pipe_kwargs)
            shared[dev] = Stage(dev, self._stream(dev), pipe, vm,
                                make_bridge_fn(vm, n_handoff))
            self.stages.append(shared[dev])

    def _own_stage(self, cfg, model, vae_model, stage_meshes,
                   pipe_kwargs) -> None:
        import torch.distributed as dist
        from .collectives import DistGroup
        ranks = [m.mesh.flatten().tolist() for m in stage_meshes]
        rank = dist.get_rank()
        mine = [i for i, r in enumerate(ranks) if rank in r]
        if len(mine) != 1 or len({len(r) for r in ranks}) != 1:
            raise ValueError(f"rank {rank} must be in exactly one of "
                             f"equal stage meshes, got {ranks}")
        if not any(g.anchor_group for g in self.plan.groups):
            raise ValueError("stages over processes hand anchors on: the "
                             "plan needs an anchor group")
        s, pos = mine[0], ranks[mine[0]].index(rank)
        self.stage_index, self.num_stages = s, len(ranks)
        self.peers = [r[pos] for r in ranks]
        self._world = DistGroup()
        dev = _device_of(model)
        self.devices = [dev]
        pipe = CausalFPSInferencePipeline(cfg, model, plan=self.plan,
                                          mesh=stage_meshes[s],
                                          **pipe_kwargs)
        vm = self._vae_on(vae_model, dev)
        self.stages = [Stage(dev, self._stream(dev), pipe, vm,
                             make_bridge_fn(vm,
                                            len(self.plan.handoff_frames)))]

    @staticmethod
    def _stream(dev: torch.device):
        return torch.cuda.Stream(device=dev) if dev.type == "cuda" else None

    @staticmethod
    def _vae_on(vae_model, dev: torch.device):
        return vae_model if _device_of(vae_model) == dev else \
            copy.deepcopy(vae_model).to(dev)

    @staticmethod
    @contextlib.contextmanager
    def _on(stage: Stage):
        """The stage's device and stream as this thread's current ones."""
        if stage.stream is None:
            yield
            return
        with torch.cuda.device(stage.device), torch.cuda.stream(stage.stream):
            yield

    @staticmethod
    def _mark(stage: Stage):
        """A CUDA event recorded on the stage's stream (None on the CPU)."""
        if stage.stream is None:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stage.stream)
        return ev

    # ------------------------------------------------------------------

    def generate(self, noise_per_chunk: Sequence[torch.Tensor],
                 cond_context: torch.Tensor, uncond_context: torch.Tensor,
                 seed: int = 0,
                 initial_latent: Optional[torch.Tensor] = None,
                 reseed_noise: Optional[Sequence[Dict[int, torch.Tensor]]]
                 = None,
                 on_chunk: Optional[Callable[[int, torch.Tensor], None]]
                 = None) -> List[torch.Tensor]:
        """Generate len(noise_per_chunk) chunks, round-robin over stages.

        Returns the denoised latent windows ([B, 21, C, H, W] fp32), each
        on its stage's device (with stage_meshes: this process's chunks,
        None in the places of the other stages').  Chunk ci draws its
        reseed noise from a `torch.Generator` on its stage's device seeded
        `seed + ci`, unless `reseed_noise[ci]` ({group index: tensor})
        hands it in.  initial_latent: chunk 0's clean context latents (the
        i2v image).  on_chunk(ci, latents): called on chunk ci's stage
        thread, with the stage's device and stream current, once the
        chunk's last group is enqueued; what it enqueues runs on that
        stream before the stage's next chunk and does not wait for later
        chunks (a server's decode of each chunk, published while later
        chunks run).  Every stage waits for the caller's current streams
        before it starts, and the caller's current streams wait for every
        stage before this returns; the host never synchronises with a
        card, except with stage_meshes after each chunk (its `done`).
        """
        W = len(noise_per_chunk)
        if self.num_stages is None:         # every stage in this process
            S, own = len(self.stages), dict(enumerate(self.stages))
            handoffs = [_Handoff() for _ in range(W)]
        else:
            S, own = self.num_stages, {self.stage_index: self.stages[0]}
            B, _, C, H, Wd = noise_per_chunk[0].shape
            shape = (B, len(self.plan.handoff_frames), C, H, Wd)
            handoffs = [_PeerHandoff(self, ci, ci + 1 == W, shape,
                                     self.stages[0].device)
                        for ci in range(W)]
        outputs: List[Optional[torch.Tensor]] = [None] * W
        log: List[dict] = [{} for _ in range(W)]
        self.dispatch_log = log
        callers = {st.device: torch.cuda.current_stream(st.device)
                   for st in own.values() if st.stream is not None}
        for st in own.values():
            if st.stream is not None:
                st.stream.wait_stream(callers[st.device])
        errors: List[BaseException] = []

        def run_chunk(ci: int) -> None:
            stage = own[ci % S]
            dev = stage.device
            t_start = time.perf_counter()
            events = {"start": self._mark(stage)}
            entry = {"chunk": ci, "stage": ci % S, "dispatch_start": t_start}
            with self._on(stage):
                noise = noise_per_chunk[ci].to(dev)
                cond, uncond = cond_context.to(dev), uncond_context.to(dev)
                initial = None
                if ci == 0 and initial_latent is not None:
                    initial = initial_latent.to(dev)
                elif ci > 0:
                    prev = handoffs[ci - 1].wait()
                    entry["received"] = time.perf_counter()
                    if prev.latents is not None:
                        if prev.event is not None:
                            stage.stream.wait_event(prev.event)
                        if stage.stream is not None and prev.latents.is_cuda:
                            prev.latents.record_stream(stage.stream)
                        initial = stage.bridge(prev.latents.to(dev))
                events["groups_start"] = self._mark(stage)

                def on_anchor(anchors: torch.Tensor) -> None:
                    events["anchor"] = self._mark(stage)
                    handoffs[ci].set(anchors, events["anchor"])

                gen = None
                rn = None if reseed_noise is None else reseed_noise[ci]
                if rn is None:
                    gen = torch.Generator(device=dev).manual_seed(seed + ci)
                out = stage.pipe.inference(
                    noise, cond, uncond, initial_latent=initial,
                    generator=gen, reseed_noise=rn, on_anchor=on_anchor)
                events["end"] = self._mark(stage)
                if on_chunk is not None:
                    on_chunk(ci, out)
            handoffs[ci].set(None)
            if self.num_stages is not None and events["end"] is not None:
                events["end"].synchronize()     # the host clock of `done`
                entry["done"] = time.perf_counter()
            outputs[ci] = out
            entry.update(dispatch_end=time.perf_counter(),
                         phase_times=dict(stage.pipe.phase_times),
                         cuda_events=events if stage.stream is not None
                         else None)
            log[ci] = entry

        def worker(si: int) -> None:
            ci = si
            try:
                for ci in range(si, W, S):
                    run_chunk(ci)
            except BaseException as e:      # re-raised by the caller below
                errors.append(e)
                for h in handoffs[ci:]:
                    h.set(None, failed=True)

        threads = [threading.Thread(target=worker, args=(si,), daemon=True,
                                    name=f"chunk-stage-{si}")
                   for si in own if si < W]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for h in handoffs:
            if h.sent is not None:
                h.sent.wait()
        if errors:
            raise errors[0]
        self.dispatch_log = [e for e in log if e]
        for st in own.values():
            if st.stream is not None:
                callers[st.device].wait_stream(st.stream)
        for out in outputs:
            if out is not None and out.is_cuda:
                out.record_stream(callers[_canonical(out.device)])
        return outputs

    def _send(self, anchors: torch.Tensor, dst: int, event):
        """Send the anchors to global rank `dst` without blocking this
        thread; returns what to `wait()` for.  Where they cross through
        host memory (`collectives.via_host`), a thread waits for the
        anchor group, copies them and sends them."""
        from .collectives import via_host
        if not via_host(self._world.pg, "send", anchors):
            return self._world.send(anchors, dst)
        box: List[BaseException] = []

        def send():
            try:
                if event is not None:
                    event.synchronize()
                self._world.send(anchors, dst).wait()
            except BaseException as e:      # re-raised by wait()
                box.append(e)

        t = threading.Thread(target=send, daemon=True, name="anchor-send")
        t.start()

        class _Sent:
            @staticmethod
            def wait():
                t.join()
                if box:
                    raise box[0]
        return _Sent()

    def device_timeline(self) -> List[dict]:
        """Each chunk's CUDA events of the last `generate`, in ms after
        chunk 0's start on the card: `start` (before the bridge),
        `groups_start` (group 0 enqueued after the bridge), `anchor`
        (after the anchor group) and `end` (after the last group).  Waits
        for those events; empty on the CPU."""
        if not self.dispatch_log or not self.dispatch_log[0].get(
                "cuda_events"):
            return []
        t0 = self.dispatch_log[0]["cuda_events"]["start"]
        rows = []
        for e in self.dispatch_log:
            evs = e["cuda_events"]
            row = {"chunk": e["chunk"], "stage": e["stage"]}
            for name, ev in evs.items():
                if ev is not None:
                    ev.synchronize()
                    row[f"{name}_ms"] = t0.elapsed_time(ev)
            rows.append(row)
        return rows

    def decode_chunks(self, chunks: Sequence[torch.Tensor],
                      streaming: bool = True,
                      uint8: bool = False) -> List[torch.Tensor]:
        """Decode each chunk on its producing stage's stream.

        uint8=True returns display-ready [B, T, H, W, 3] uint8 frames
        through the production bf16 decode (`vae.decode_to_frames`);
        otherwise fp32 pixels [B, T, 3, H, W] in [-1, 1] (`decode_streaming`
        or the whole-window `decode`).  The caller's streams wait for the
        decodes."""
        vids = []
        for ci, lat in enumerate(chunks):
            if lat is None:         # another process's chunk
                vids.append(None)
                continue
            stage = self.stages[ci % len(self.stages)]
            caller = (torch.cuda.current_stream(stage.device)
                      if stage.stream is not None else None)
            if caller is not None:
                stage.stream.wait_stream(caller)
            with self._on(stage):
                if uint8:
                    out = vae_mod.decode_to_frames(stage.vae, lat)[0]
                else:
                    dec = (vae_mod.decode_streaming if streaming
                           else vae_mod.decode)
                    out = dec(stage.vae, lat.float())
            if caller is not None:
                caller.wait_stream(stage.stream)
                out.record_stream(caller)
            vids.append(out)
        return vids

