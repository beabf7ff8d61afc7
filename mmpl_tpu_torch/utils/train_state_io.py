"""Training checkpoints, resume and the export to the upstream `.pt`.

Port of `mmpl_tpu/utils/train_state_io.py`.  The JAX trainer checkpoints
its pytree with orbax; the port writes one `torch.save` dict instead (a
different format: neither package reads the other's checkpoint):

  * "model": the fp32 master weights (the trainer's state dict), or
    "models": one state dict per trained model (the distillation trainer:
    generator, fake score, GAN head),
  * "optimizer": the AdamW state dict (`exp_avg`, `exp_avg_sq` and `step`
    of each parameter, and the hyper-parameters), or "opt_g" and "opt_c",
    the generator's and the critic's,
  * "ema": the EMA shadow,
  * "step": the number of steps taken,
  * "rng": the states of the trainer's `torch.Generator`s (and of the
    rollout-length numpy Generator), so that a resumed run draws the
    numbers an unbroken run would,
  * "data": with `--data-dir`, the batches the data iterator has yielded.

A checkpoint `<dir>/stepN` is a directory holding `train_state.pt`, which
is written under a temporary name and renamed into place, so a reader
never sees half a file.

Host-resident state (the trainer's `--offload-opt`: `utils/memory.
HostAdamW`'s moments, the host EMA shadow) is written from host memory as
it lies, in the same format as resident state; a resume with the flag
reads the file into host memory (`map_location="cpu"`, the models copied
onto the card as they load) and `HostAdamW.load_state_dict` keeps the
moments there, and a sharded restore loads the DCP shards in place into
the host tensors.  None of it passes through the card.

Under the trainer's `--mesh` the masters, AdamW states and EMA are FSDP2
DTensors, and `save_sharded` writes them with `torch.distributed.
checkpoint` (each rank its shards, `.metadata` and `*.distcp`) beside one
`rank<r>.pt` per rank holding that rank's own entries (`LOCAL_KEYS`: the
step, its generators' states, the data position) and the mesh's shape.
The directory is written as `<dir>/stepN.tmp` and renamed once every rank
has written; `restore_sharded` loads it onto a mesh of the same shape
only.  `torch.distributed.checkpoint` keeps one copy of the entries that
share a name and offsets across ranks, which is right for what every tp
rank holds whole and wrong for a tp slice: so under tp every tensor that
tp splits (`parallel/mesh.tp_split_dim`: parameters, their AdamW states
and EMA shadows) is written under its name and `@tp<r>`, one entry per
tp rank.  `sharded_to_state` reads one back into plain tensors without a
process group (tests, comparisons).  `export_generator_pt` writes the MMPL inference
monolith `{'generator', 'generator_ema'}` with `model.`-prefixed fp32
tensors in the upstream WanModel layout, as the JAX export does.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Dict, Optional

import torch

#: the file of a checkpoint directory
STATE_FILE = "train_state.pt"
#: the entries of a train state that each rank of a mesh keeps itself
LOCAL_KEYS = ("step", "rng", "data")
#: the file of rank r's own entries in a sharded checkpoint
RANK_FILE = "rank{}.pt"


def _save_atomic(obj, path: str) -> int:
    """torch.save to a temporary name, then rename; returns the bytes."""
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return os.path.getsize(path)


def save_checkpoint(path: str, state: Dict[str, Any]) -> int:
    """Write `state` (tensors, numbers and dicts of them) to
    `path/train_state.pt` atomically.  Returns the file's bytes."""
    os.makedirs(path, exist_ok=True)
    return _save_atomic(state, os.path.join(path, STATE_FILE))


def restore_checkpoint(path: str,
                       template: Optional[Dict[str, Any]] = None,
                       map_location="cpu") -> Dict[str, Any]:
    """Read the checkpoint directory `path` written by `save_checkpoint`.

    With a `template` (a dict of the same layout, e.g. the trainer's
    current state), every key of the template must be in the checkpoint,
    and each tensor of `template["model"]` (and of each model of
    `template["models"]`, the distillation trainer's) must have its saved
    tensor's shape and dtype; a mismatch raises and names the tensor."""
    state = torch.load(os.path.join(path, STATE_FILE),
                       map_location=map_location, weights_only=True)
    if template is not None:
        missing = sorted(set(template) - set(state))
        if missing:
            raise KeyError(f"checkpoint {path} lacks {missing}")
        models = {"model": (template.get("model", {}),
                            state.get("model", {}))}
        for key, like in template.get("models", {}).items():
            if key not in state["models"]:
                raise KeyError(f"checkpoint {path} lacks model {key!r}")
            models[key] = (like, state["models"][key])
        for what, (want, saved) in models.items():
            for name, like in want.items():
                got = saved.get(name)
                if got is None or got.shape != like.shape \
                        or got.dtype != like.dtype:
                    raise ValueError(
                        f"checkpoint {path}: {what} tensor {name!r} is "
                        f"{None if got is None else (tuple(got.shape), got.dtype)}"
                        f", expected {(tuple(like.shape), like.dtype)}")
    return state


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def _tp_keys(tree, tp_rank: int, back: bool = False):
    """`tree` with every key that names a tp-split tensor given (or, with
    `back`, rid of) the suffix `@tp<tp_rank>`; the values are the same
    objects."""
    if not isinstance(tree, dict):
        return tree
    from ..parallel.mesh import tp_split_dim
    tag = f"@tp{tp_rank}"
    out = {}
    for k, v in tree.items():
        if back and isinstance(k, str) and k.endswith(tag):
            k = k[:-len(tag)]
        elif not back and isinstance(k, str) and tp_split_dim(k) is not None:
            k = k + tag
        out[k] = _tp_keys(v, tp_rank, back)
    return out


def save_sharded(path: str, state: Dict[str, Any],
                 mesh_shape: Dict[str, int], tp_rank: int = 0) -> int:
    """Write `state` on every rank of the process group: its tensors
    (DTensors and replicated tensors, `torch.distributed.checkpoint`; tp
    slices under keys of their own, `_tp_keys`) and each rank's
    `LOCAL_KEYS` with the mesh's shape.  tp_rank: this rank's coordinate
    on the mesh's tp dim.  Atomic: written to `path.tmp`, renamed by rank
    0 after every rank has written.  Returns the directory's bytes."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp
    rank = dist.get_rank()
    tmp = f"{path}.tmp"
    if rank == 0:
        shutil.rmtree(tmp, ignore_errors=True)
    dist.barrier()
    tensors = {k: v for k, v in state.items() if k not in LOCAL_KEYS}
    if mesh_shape.get("tp", 1) > 1:
        tensors = _tp_keys(tensors, tp_rank)
    dcp.save(tensors, checkpoint_id=tmp)
    local = {k: state[k] for k in LOCAL_KEYS if k in state}
    local["mesh"] = dict(mesh_shape)
    torch.save(local, os.path.join(tmp, RANK_FILE.format(rank)))
    dist.barrier()
    if rank == 0:
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
    dist.barrier()
    return _dir_bytes(path)


def _rank_entries(path: str, rank: int) -> Dict[str, Any]:
    return torch.load(os.path.join(path, RANK_FILE.format(rank)),
                      map_location="cpu", weights_only=True)


def restore_sharded(path: str, template: Dict[str, Any],
                    mesh_shape: Dict[str, int],
                    tp_rank: int = 0) -> Dict[str, Any]:
    """Load the checkpoint `path` written by `save_sharded` into the
    tensors of `template` (the state of a fresh trainer on this mesh; its
    tensors are overwritten in place; this rank's tp slices from their
    own keys) and return them with this rank's `LOCAL_KEYS`.  Exits
    naming both shapes where `path` was written on another mesh."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp
    if not os.path.exists(os.path.join(path, ".metadata")):
        raise SystemExit(f"--resume {path}: not a sharded checkpoint (a "
                         f"run under --mesh writes one)")
    saved = _rank_entries(path, 0)["mesh"]
    if saved != dict(mesh_shape):
        raise SystemExit(f"--resume {path} was written on the mesh "
                         f"{saved}; this run's mesh is {dict(mesh_shape)}")
    tensors = {k: v for k, v in template.items() if k not in LOCAL_KEYS}
    split = mesh_shape.get("tp", 1) > 1
    if split:
        tensors = _tp_keys(tensors, tp_rank)
    saved_keys = dcp.FileSystemReader(path).read_metadata() \
        .state_dict_metadata.keys()
    _prune(tensors, "", tuple(saved_keys))
    dcp.load(tensors, checkpoint_id=path)
    if split:
        tensors = _tp_keys(tensors, tp_rank, back=True)
    local = _rank_entries(path, dist.get_rank())
    return {**tensors, **{k: local[k] for k in LOCAL_KEYS if k in local}}


def _prune(tree: Dict[str, Any], prefix: str, saved: tuple) -> None:
    """Drop the entries of `tree` that the checkpoint does not hold: a
    fresh optimizer's state dict holds every parameter, the saved one only
    those that had a gradient (a parameter AdamW never stepped has no
    state, and keeps none after the load)."""
    for k in list(tree):
        key = f"{prefix}{k}"
        if not any(s == key or s.startswith(key + ".") for s in saved):
            del tree[k]
        elif isinstance(tree[k], dict):
            _prune(tree[k], key + ".", saved)


def sharded_to_state(path: str) -> Dict[str, Any]:
    """A sharded checkpoint as plain CPU tensors, read without a process
    group: {"tensors": the whole tensors by key, "ranks": each rank's own
    entries and mesh}."""
    from torch.distributed.checkpoint.format_utils import dcp_to_torch_save
    ranks = []
    while os.path.exists(os.path.join(path, RANK_FILE.format(len(ranks)))):
        ranks.append(_rank_entries(path, len(ranks)))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "state.pt")
        dcp_to_torch_save(path, out)
        tensors = torch.load(out, map_location="cpu", weights_only=False)
    return {"tensors": tensors, "ranks": ranks}


def _upstream_state(named: Dict[str, torch.Tensor], cfg) -> Dict[str, Any]:
    """A WanDiT's (unfused, t2v) tensors under the upstream names and
    shapes, fp32, on the CPU, with the `model.` prefix."""
    from .checkpoint import dit_source_key
    out = {}
    for key, t in named.items():
        if ".qkv." in key:
            raise ValueError("export takes an unfused DiT (self_attn.q/k/v)")
        t = t.detach().to(device="cpu", dtype=torch.float32)
        if key == "patch_embedding.weight":
            t = t.reshape(cfg.dim, cfg.in_dim, *cfg.patch_size)
        out[f"model.{dit_source_key(key)}"] = t.contiguous()
    return out


def export_generator_pt(path: str, model, ema: Optional[Dict[str,
                        torch.Tensor]], cfg) -> None:
    """Write `{'generator': ..., 'generator_ema': ...}` (the EMA only when
    given) of `model` (a module, or its parameters by name) with
    `model.`-prefixed fp32 tensors in the upstream layout: the
    `t2v_14B_8k.pt` format that `utils/checkpoint.load_mmpl_generator`
    (and the JAX package's) reads.  t2v configs only: the JAX export has
    no i2v leaves, so an i2v file would not load back."""
    if cfg.model_type != "t2v":
        raise NotImplementedError(
            f"export of a {cfg.model_type} DiT: the upstream export "
            f"(mmpl_tpu export_generator_pt) writes t2v leaves only")
    params = model if isinstance(model, dict) else dict(
        model.named_parameters())
    blob = {"generator": _upstream_state(params, cfg)}
    if ema is not None:
        blob["generator_ema"] = _upstream_state(ema, cfg)
    _save_atomic(blob, path)
