"""HTTP serving layer: the parallel T2V / I2V generation API.

Port of `mmpl_tpu/serving/server.py` (the reference's
`MMPL_t2v/fastapi_parallel_t2v_server.py` and its i2v variant), with the
same endpoints and JSON schemas:

  GET  /health                       (:690)
  POST /parallel_text_2_video        (:701)
  POST /parallel_i2v                 (i2v server)
  GET/POST /status/{task_id}         (:754-756)
  POST /openapi/task_search          (:727)

The server is stdlib `http.server.ThreadingHTTPServer` with a worker
thread per request's background generation; the port keeps its own copy
of this code, which imports nothing of the JAX package.  Generation is a
pluggable backend callable (`backend(prompt, num_chunks, seed, image) ->
list of video paths`): `make_pipeline_backend` wires the port's
`parallel/chunk_pipeline.ChunkParallelPipeline` on the cards, tests inject
stubs.  Prompt expansion posts to an external HTTP service and falls back
to the original prompt on any failure (:263-296); callbacks POST with 3
retries (:298-360); S3 upload is replaced by a local artifact directory
unless an uploader is injected.

Capacity model: one generation runs at a time per server process
(`gen_lock` in `make_pipeline_backend`).  Accepted requests queue FIFO on
the lock while their task status stays PROCESSING: a request's chunks
already occupy every pipeline stage, so a second generation in flight
would only interleave on the same cards (the reference serialises per GPU
group the same way and models the queue with `need_wait`).  Scaling
concurrent requests means one server process per card group behind an
external balancer.
"""

from __future__ import annotations

import collections
import datetime
import json
import logging
import os
import queue
import threading
import traceback
import urllib.request
import uuid
from dataclasses import dataclass, field
from enum import Enum
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional

logger = logging.getLogger("mmpl_tpu_torch.serving")


class TaskStatus(Enum):
    NOT_STARTED = "0"
    PROCESSING = "1"
    SUCCESS = "2"
    FAILED = "3"


class ResponseCode(Enum):
    SUCCESS = 10000
    NOT_FOUND = 10404
    SERVER_ERROR = 10903


@dataclass
class ParallelServerConfig:
    host: str = "0.0.0.0"
    port: int = 8001
    output_folder: str = "videos/parallel_fps"
    use_ema: bool = False
    num_output_frames: int = 21
    num_chunks: int = 4
    use_text_expansion: bool = False
    text_expansion_url: str = ""
    prompt_log_file: str = "prompt_extend.txt"
    service_type: str = "parallel_t2v"
    # int8 options forwarded to each pipeline stage (ops/quant.py)
    quantize: Optional[str] = None
    quantize_cache: bool = False


class TaskStorage:
    """LRU task store (fastapi_parallel_t2v_server.py:240-261)."""

    def __init__(self, max_size: int = 10000):
        self.max_size = max_size
        self.tasks: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()

    def add_task(self, key: str, value: dict) -> None:
        with self._lock:
            if key in self.tasks:
                del self.tasks[key]
            if len(self.tasks) >= self.max_size:
                self.tasks.popitem(last=False)
            self.tasks[key] = value

    def get_task(self, key: str) -> Optional[dict]:
        with self._lock:
            return self.tasks.get(key)


class TextExpander:
    """External prompt-expansion HTTP hook with original-prompt fallback."""

    def __init__(self, url: str, log_file: str = "prompt_extend.txt"):
        self.url = url
        self.log_file = log_file

    def expand(self, prompt: str) -> str:
        if not self.url:
            return prompt
        try:
            req = urllib.request.Request(
                self.url, data=json.dumps({"prompt": prompt}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                expanded = json.loads(r.read())["expanded"]
            try:
                with open(self.log_file, "a", encoding="utf-8") as f:
                    f.write(expanded + "\n")
            except OSError:
                pass
            return expanded
        except Exception as e:
            logger.warning("prompt expansion failed (%s); using original", e)
            return prompt


class CallbackHandler:
    """POST-with-retry result callback (:298-360)."""

    @staticmethod
    def execute_callback(callback_url: str, seqid: str, code: int,
                         message: str, flag: int, video_urls: List[str],
                         cover_images: List[str], text_en: str,
                         max_retries: int = 3) -> bool:
        if not callback_url:
            return True
        payload = {
            "seqid": seqid, "code": code, "message": message, "flag": flag,
            "data": {"video": video_urls, "cover_image": cover_images,
                     "text_en": text_en},
        }
        for attempt in range(max_retries):
            try:
                req = urllib.request.Request(
                    callback_url, data=json.dumps(payload).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=30):
                    return True
            except Exception as e:
                logger.warning("callback attempt %d failed: %s",
                               attempt + 1, e)
        return False


class VideoProcessor:
    """First-frame cover extraction
    (fastapi_parallel_i2v_server.py:403-445; the reference tries moviepy ->
    torchvision -> OpenCV; here imageio / npy through utils.video_io)."""

    @staticmethod
    def extract_first_frame(video_path: str, output_path: str) -> bool:
        try:
            from PIL import Image
            from ..utils.video_io import read_video
            frames = read_video(video_path)
            out_dir = os.path.dirname(output_path)
            if out_dir:
                os.makedirs(out_dir, exist_ok=True)
            Image.fromarray(frames[0]).save(output_path, format="PNG")
            return True
        except Exception as e:
            logger.warning("cover extraction failed for %s: %s",
                           video_path, e)
            return False


class MediaMetadataHandler:
    """AIGC provenance metadata injection
    (fastapi_parallel_t2v_server.py:124-175): a JSON blob under the `AIGC`
    key — PNG text chunk via PIL, mp4 container tag via ffmpeg.  Without an
    ffmpeg binary the video passes through unchanged (metadata skipped,
    logged)."""

    METADATA_TEMPLATE = {
        "Label": "1",
        "ContentProducer": "TeleStudio",
        "ProduceID": "",
        "ReservedCode1": "",
        "ContentPropagator": "TeleStudio",
        "PropagateID": "",
        "ReservedCode2": "",
    }

    @classmethod
    def _metadata(cls, seqid: str) -> str:
        md = dict(cls.METADATA_TEMPLATE)
        md["ProduceID"] = seqid
        md["PropagateID"] = seqid
        return json.dumps(md)

    @classmethod
    def write_png_metadata(cls, seqid: str, input_png: str, output_png: str,
                           keyword: str = "AIGC") -> str:
        from PIL import Image, PngImagePlugin
        img = Image.open(input_png)
        meta = PngImagePlugin.PngInfo()
        meta.add_text(keyword, cls._metadata(seqid))
        img.save(output_png, pnginfo=meta)
        return output_png

    @classmethod
    def write_video_metadata(cls, seqid: str, input_video: str,
                             output_video: str) -> str:
        import shutil
        import subprocess
        if input_video.endswith(".mp4") and shutil.which("ffmpeg"):
            cmd = ["ffmpeg", "-y", "-i", input_video,
                   "-metadata", f"AIGC={cls._metadata(seqid)}",
                   "-movflags", "use_metadata_tags", "-c", "copy",
                   output_video]
            proc = subprocess.run(cmd, capture_output=True)
            if proc.returncode == 0:
                return output_video
            logger.warning("ffmpeg metadata injection failed: %s",
                           proc.stderr[-200:])
        # no ffmpeg / non-mp4 fallback: ship the original artifact
        logger.info("video metadata skipped for %s (no mp4 muxer)",
                    input_video)
        return input_video


class ParallelVideoGenerationService:
    """Task orchestration: expansion -> generation -> artifacts -> callback."""

    def __init__(self, config: ParallelServerConfig,
                 backend: Optional[Callable] = None,
                 uploader: Optional[Callable[[str], str]] = None):
        self.config = config
        self.backend = backend
        self.uploader = uploader or (lambda path: path)
        self.task_storage = TaskStorage()
        self.expander = TextExpander(
            config.text_expansion_url if config.use_text_expansion else "",
            config.prompt_log_file)
        os.makedirs(config.output_folder, exist_ok=True)
        # capacity model (the reference surfaces per-GPU busy-ness via its
        # need_wait flag, fastapi_parallel_t2v_server.py:690,754): FIFO
        # tickets over the single generation lock so clients can tell
        # "busy, k ahead of you" from "idle" via /health and task status.
        self._qlock = threading.Lock()
        self._next_ticket = 0      # tickets issued
        self._done_tickets = 0     # tickets completed (success or failure)
        self._task_ticket: dict = {}

    def is_model_loaded(self) -> bool:
        return self.backend is not None

    def queue_state(self) -> dict:
        """Live capacity snapshot: depth counts tasks submitted and not yet
        finished (position 0 of the FIFO is the one generating now)."""
        with self._qlock:
            depth = self._next_ticket - self._done_tickets
            return {"queue_depth": depth, "busy": depth > 0}

    def _enqueue(self, task_id: str) -> None:
        with self._qlock:
            self._task_ticket[task_id] = self._next_ticket
            self._next_ticket += 1

    def _finish(self, task_id: str) -> None:
        with self._qlock:
            self._done_tickets += 1
            self._task_ticket.pop(task_id, None)

    def get_task_status(self, key: str) -> Optional[dict]:
        rec = self.task_storage.get_task(key)
        if rec is None:
            return None
        if rec.get("status") == TaskStatus.PROCESSING.value:
            with self._qlock:
                ticket = self._task_ticket.get(rec.get("task_id"))
                if ticket is not None:
                    # 0 = generating now; k = k live tasks ahead.  Count
                    # LIVE smaller tickets rather than ticket-done_tickets:
                    # threading.Lock is unfair, so a later ticket can finish
                    # first and the subtraction would go stale/negative.
                    pos = sum(1 for t in self._task_ticket.values()
                              if t < ticket)
                    rec = dict(rec, queue_position=pos)
        return rec

    def _store(self, task_id: str, seqid: str, code: int, message: str,
               flag: int, status: str, videos: List[str],
               covers: List[str], text_en: str,
               progress: Optional[dict] = None) -> dict:
        rec = {
            "task_id": task_id, "seqid": seqid, "code": code,
            "message": message, "flag": flag, "status": status,
            "data": {"video": videos, "cover_image": covers,
                     "text_en": text_en},
        }
        if progress is not None:
            rec["progress"] = progress
        self.task_storage.add_task(task_id, rec)
        if seqid != task_id:
            self.task_storage.add_task(seqid, rec)
        return rec

    def _publish_artifacts(self, task_id: str, seqid: str,
                           paths: List[str], chunk_offset: int = 0):
        """Per-chunk publication (fastapi_parallel_t2v_server.py:618-653):
        extract the first frame as a cover PNG, inject AIGC metadata into
        both artifacts, upload, return (video_urls, cover_urls)."""
        ts = datetime.datetime.now().strftime("%Y%m%d%H%M%S")
        urls, covers = [], []
        for i, path in enumerate(paths, start=chunk_offset):
            base = os.path.join(self.config.output_folder,
                                f"{task_id}_{ts}_chunk{i + 1}")
            media_video = MediaMetadataHandler.write_video_metadata(
                seqid, path, base + "_media" + os.path.splitext(path)[1])
            url = self.uploader(media_video)
            if url:
                urls.append(url)
            frame_png = base + "_frame.png"
            if VideoProcessor.extract_first_frame(path, frame_png):
                media_png = MediaMetadataHandler.write_png_metadata(
                    seqid, frame_png, base + "_media.png")
                cover = self.uploader(media_png)
                if cover:
                    covers.append(cover)
        return urls, covers

    def generate_parallel_video_task(self, request: dict,
                                     task_id: str) -> None:
        seqid = request.get("seqid") or task_id
        prompt = request["prompt"]
        self._enqueue(task_id)
        try:
            self._store(task_id, seqid, ResponseCode.SUCCESS.value,
                        "processing", 1, TaskStatus.PROCESSING.value,
                        [], [], prompt)
            text = self.expander.expand(prompt) \
                if request.get("use_expansion", False) else prompt
            num_chunks = int(request.get("num_chunks",
                                         self.config.num_chunks))

            # Progressive per-chunk publication (the reference i2v server
            # appends each chunk's result to a lock-guarded list as it
            # finishes, fastapi_parallel_i2v_server.py:706-835): backends
            # that accept `on_chunk` get a callback per finished chunk;
            # the task record carries the artifacts so far + a progress
            # field while still PROCESSING.
            done_urls: List[str] = []
            done_covers: List[str] = []
            chunk_counter = {"n": 0}

            def on_chunk(path: str) -> None:
                u, c = self._publish_artifacts(
                    task_id, seqid, [path],
                    chunk_offset=chunk_counter["n"])
                chunk_counter["n"] += 1
                done_urls.extend(u)
                done_covers.extend(c)
                self._store(task_id, seqid, ResponseCode.SUCCESS.value,
                            "processing", 1, TaskStatus.PROCESSING.value,
                            list(done_urls), list(done_covers), text,
                            progress={"done": chunk_counter["n"],
                                      "total": num_chunks})

            import inspect
            kwargs = {}
            try:
                if "on_chunk" in inspect.signature(
                        self.backend).parameters:
                    kwargs["on_chunk"] = on_chunk
            except (TypeError, ValueError):
                pass
            paths = self.backend(
                prompt=text,
                num_chunks=num_chunks,
                seed=int(request.get("seed", 0)),
                image=request.get("image"),
                **kwargs,
            )
            if kwargs and chunk_counter["n"] == len(paths):
                # every chunk already published progressively
                urls, covers = done_urls, done_covers
            else:
                urls, covers = self._publish_artifacts(task_id, seqid,
                                                       paths)
            self._store(task_id, seqid, ResponseCode.SUCCESS.value, "ok", 1,
                        TaskStatus.SUCCESS.value, urls, covers, text)
            CallbackHandler.execute_callback(
                request.get("callback_url"), seqid,
                ResponseCode.SUCCESS.value, "ok", 1, urls, covers, text)
        except Exception as e:
            logger.error("task %s failed: %s\n%s", task_id, e,
                         traceback.format_exc())
            self._store(task_id, seqid, ResponseCode.SERVER_ERROR.value,
                        str(e), 0, TaskStatus.FAILED.value, [], [], prompt)
            CallbackHandler.execute_callback(
                request.get("callback_url"), seqid,
                ResponseCode.SERVER_ERROR.value, str(e), 0, [], [], prompt)
        finally:
            self._finish(task_id)


def make_handler(service: ParallelVideoGenerationService,
                 config: ParallelServerConfig):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            logger.debug(fmt, *args)

        def _send(self, obj, status=200):
            body = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            if n == 0:
                return {}
            try:
                return json.loads(self.rfile.read(n))
            except json.JSONDecodeError:
                return {}

        def _not_found(self, ident_key, ident):
            return {ident_key: ident, "code": ResponseCode.NOT_FOUND.value,
                    "message": "task not found", "flag": 0,
                    "status": "not_found",
                    "data": {"video": [], "cover_image": [], "text_en": ""}}

        def do_GET(self):
            if self.path == "/health":
                self._send({
                    "status": "healthy",
                    "model_loaded": service.is_model_loaded(),
                    "timestamp": datetime.datetime.now().isoformat(),
                    "service_type": config.service_type,
                    "num_chunks": config.num_chunks,
                    **service.queue_state(),
                })
            elif self.path.startswith("/status/"):
                task_id = self.path[len("/status/"):]
                rec = service.get_task_status(task_id)
                self._send(rec or self._not_found("task_id", task_id))
            else:
                self._send({"error": "not found"}, 404)

        def do_POST(self):
            if self.path in ("/parallel_text_2_video", "/parallel_i2v"):
                if not service.is_model_loaded():
                    self._send({"detail": "model not loaded"}, 503)
                    return
                body = self._body()
                if "prompt" not in body:
                    self._send({"detail": "missing required field: prompt"},
                               422)
                    return
                task_id = str(uuid.uuid4())
                seqid = body.get("seqid") or task_id
                threading.Thread(
                    target=service.generate_parallel_video_task,
                    args=(body, task_id), daemon=True).start()
                self._send({
                    "task_id": task_id, "video_paths": [],
                    "original_prompt": body["prompt"],
                    "expanded_prompt": None, "seqid": seqid, "flag": 1,
                    "status": TaskStatus.PROCESSING.value,
                    "num_chunks": int(body.get("num_chunks",
                                               config.num_chunks)),
                })
            elif self.path == "/openapi/task_search":
                body = self._body()
                seqid = body.get("seqid", "")
                rec = service.get_task_status(seqid)
                self._send(rec or self._not_found("seqid", seqid))
            elif self.path.startswith("/status/"):
                task_id = self.path[len("/status/"):]
                rec = service.get_task_status(task_id)
                self._send(rec or self._not_found("task_id", task_id))
            else:
                self._send({"error": "not found"}, 404)

    return Handler


def create_server(config: ParallelServerConfig,
                  backend: Optional[Callable] = None,
                  uploader: Optional[Callable] = None
                  ) -> ThreadingHTTPServer:
    service = ParallelVideoGenerationService(config, backend, uploader)
    server = ThreadingHTTPServer((config.host, config.port),
                                 make_handler(service, config))
    server.service = service  # type: ignore[attr-defined]
    return server


def make_pipeline_backend(cfg, model, vae_model, text_encoder,
                          config: ParallelServerConfig, devices=None,
                          lat_hw=(60, 104), **pipe_kwargs):
    """The production backend: chunk-parallel generation, one video file
    per chunk.  lat_hw: the latent grid of a frame ((60, 104) is
    480x832; smoke mode passes a tiny one).  devices: the stages (default
    every visible card); pipe_kwargs go to each stage's pipeline
    (`sampling_steps`, `dtype`, ...).  text_encoder(prompts) returns
    {"prompt_embeds": [len(prompts), T, text_dim]}.  The backend's
    `pipe` attribute is its `ChunkParallelPipeline` (whose `dispatch_log`
    holds the last request's chunk timeline)."""
    import torch

    from ..core.geometry import i2v_plan
    from ..models import vae as vae_mod
    from ..parallel.chunk_pipeline import ChunkParallelPipeline
    from ..utils.media import load_image
    from ..utils.video_io import write_video

    is_i2v = config.service_type == "parallel_i2v"
    gen_lock = threading.Lock()
    pipe = ChunkParallelPipeline(
        cfg, model, vae_model, devices=devices,
        plan=i2v_plan() if is_i2v else None,
        quantize=config.quantize, quantize_cache=config.quantize_cache,
        **pipe_kwargs)
    dev0 = pipe.devices[0]
    vae0 = pipe.stages[0].vae
    neg = cfg.sample_neg_prompt

    def backend(prompt: str, num_chunks: int, seed: int,
                image=None, on_chunk=None) -> List[str]:
        # the text and image encodes run before the generation lock: a
        # queued request prepares its conditioning while the current one
        # denoises
        cond = text_encoder([prompt])["prompt_embeds"].to(dev0)
        uncond = text_encoder([neg])["prompt_embeds"].to(dev0)
        gen = torch.Generator(device=dev0).manual_seed(seed)
        noises = [torch.randn((1, 21, 16) + tuple(lat_hw), generator=gen,
                              device=dev0) for _ in range(num_chunks)]
        initial = None
        if image is not None:
            # i2v: the request image (URL, base64 or path), VAE-encoded as
            # the first chunk's clean latent
            # (fastapi_parallel_i2v_server.py:294-345,740-747)
            img = load_image(image, lat_hw[0] * 8, lat_hw[1] * 8)
            initial = vae_mod.encode(vae0, torch.from_numpy(img).to(
                dev0)[None, None])
        # Each chunk is decoded on its stage right after its last group,
        # before that stage's next chunk, and copied to the host there
        # (`generate`'s on_chunk); a writer thread writes the files in
        # chunk order as their copies land, so each file is published
        # (on_chunk) while later chunks still run.
        landed: "queue.Queue" = queue.Queue()

        def decode(ci: int, latents) -> None:
            stage = pipe.stages[ci % len(pipe.stages)]
            frames = vae_mod.decode_to_frames(stage.vae, latents)[0][0]
            ready = None
            if frames.is_cuda:
                host = torch.empty(frames.shape, dtype=frames.dtype,
                                   pin_memory=True)
                host.copy_(frames, non_blocking=True)
                ready = torch.cuda.Event(blocking=True)
                ready.record()
                frames = host
            landed.put((ci, frames, ready))

        paths: List[str] = []
        failed: List[BaseException] = []

        def write_files() -> None:
            pending = {}
            try:
                while len(paths) < num_chunks:
                    item = landed.get()
                    if item is None:            # the generation failed
                        return
                    pending[item[0]] = item[1:]
                    while len(paths) in pending:
                        frames, ready = pending.pop(len(paths))
                        if ready is not None:
                            ready.synchronize()
                        out = os.path.join(
                            config.output_folder,
                            f"{prompt[:50]}-chunk{len(paths) + 1}"
                            f"-seed{seed}.mp4")
                        paths.append(write_video(out, frames.numpy(),
                                                 fps=16))
                        if on_chunk is not None:
                            on_chunk(paths[-1])
            except BaseException as e:      # re-raised by the backend
                failed.append(e)

        # one generation at a time: concurrent requests share the stages
        with gen_lock:
            writer = threading.Thread(target=write_files, daemon=True,
                                      name="chunk-writer")
            writer.start()
            try:
                pipe.generate(noises, cond, uncond, seed=seed,
                              initial_latent=initial, on_chunk=decode)
            finally:
                landed.put(None)
                writer.join()
        if failed:
            raise failed[0]
        return paths

    backend.pipe = pipe     # type: ignore[attr-defined]
    return backend


def smoke_text_encoder(cfg, device):
    """Random text states standing in for umT5 in smoke mode: one seeded
    draw per prompt list (a stable hash, so a prompt always gets the same
    states)."""
    import zlib

    import torch

    def encode(prompts: List[str]) -> dict:
        seed = zlib.crc32("\0".join(prompts).encode("utf-8"))
        g = torch.Generator(device=device).manual_seed(seed)
        return {"prompt_embeds": torch.randn(
            (len(prompts), cfg.text_len, cfg.text_dim), generator=g,
            device=device)}
    return encode


def smoke_models(device):
    """Smoke mode's models: the tiny config with random weights (seeds 0
    and 1), random text states and an 8x8 latent grid.  Returns (cfg,
    model, vae_model, text_encoder, lat_hw)."""
    import torch

    from ..core.config import tiny_test_config
    from ..models import dit, vae
    cfg = tiny_test_config()
    g = lambda s: torch.Generator(device=device).manual_seed(s)
    return (cfg, dit.init_dit_params(cfg, g(0), torch.float32, device),
            vae.init_vae_params(g(1), torch.float32, device),
            smoke_text_encoder(cfg, device), (8, 8))


def parse_args(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="mmpl_tpu_torch video API "
                                             "server")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8001)
    ap.add_argument("--service-type", default="parallel_t2v",
                    choices=["parallel_t2v", "parallel_i2v"])
    ap.add_argument("--num-chunks", type=int, default=4)
    ap.add_argument("--output-folder", default="videos/parallel_fps")
    ap.add_argument("--model", default="t2v-1.3B")
    ap.add_argument("--checkpoint-path", default=None,
                    help="MMPL generator .pt; absent = smoke mode")
    ap.add_argument("--wan-dir", default=None)
    ap.add_argument("--use-ema", action="store_true")
    ap.add_argument("--quantize", default=None,
                    choices=["int8", "int8wo", "auto"])
    ap.add_argument("--quantize-cache", action="store_true")
    ap.add_argument("--use-text-expansion", action="store_true")
    ap.add_argument("--text-expansion-url", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def build_server(argv=None) -> ThreadingHTTPServer:
    """The server `main` runs, not yet serving: without --checkpoint-path
    the tiny config with random weights and random text states (smoke
    mode), so the whole HTTP -> chunk pipeline -> video path runs on any
    card; with it the MMPL generator, the VAE, umT5 and its tokenizer
    (`cli.load_models`)."""
    from ..cli import load_models
    from ..core.config import WAN_CONFIGS
    from ..parallel.chunk_pipeline import default_devices
    from ..utils.device import resolve_device, set_float32_precision

    args = parse_args(argv)
    device = resolve_device(args.device)
    set_float32_precision()
    devices = default_devices() if device.type == "cuda" else [device]
    smoke = args.checkpoint_path is None
    if smoke:
        logger.warning("no --checkpoint-path: SMOKE mode (random weights)")
        cfg, model, vae_model, text_encoder, lat_hw = smoke_models(
            devices[0])
    else:
        cfg = WAN_CONFIGS[args.model]
        model, vae_model, text_encoder = load_models(
            cfg, args.checkpoint_path, args.wan_dir, args.use_ema,
            devices[0])
        lat_hw = (60, 104)

    srv_cfg = ParallelServerConfig(
        host=args.host, port=args.port, output_folder=args.output_folder,
        num_chunks=args.num_chunks, service_type=args.service_type,
        use_text_expansion=args.use_text_expansion,
        text_expansion_url=args.text_expansion_url,
        quantize=args.quantize, quantize_cache=args.quantize_cache,
        use_ema=args.use_ema)
    backend = make_pipeline_backend(cfg, model, vae_model, text_encoder,
                                    srv_cfg, devices=devices, lat_hw=lat_hw)
    server = create_server(srv_cfg, backend=backend)
    logger.info("serving %s on %s:%d (%s)", args.service_type, args.host,
                server.server_address[1], "SMOKE" if smoke else args.model)
    return server


def main(argv=None):
    """Launch the serving process (the reference's `uvicorn
    fastapi_parallel_t2v_server:app` entry, :783-838)."""
    logging.basicConfig(level=logging.INFO)
    server = build_server(argv)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
