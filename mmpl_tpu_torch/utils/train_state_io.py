"""Training checkpoints, resume and the export to the upstream `.pt`.

Port of `mmpl_tpu/utils/train_state_io.py`.  The JAX trainer checkpoints
its pytree with orbax; the port writes one `torch.save` dict instead (a
different format: neither package reads the other's checkpoint):

  * "model": the fp32 master weights (the trainer's state dict),
  * "optimizer": the AdamW state dict (`exp_avg`, `exp_avg_sq` and `step`
    of each parameter, and the hyper-parameters),
  * "ema": the EMA shadow,
  * "step": the number of steps taken,
  * "rng": the states of the trainer's `torch.Generator`s, so that a
    resumed run draws the numbers an unbroken run would.

A checkpoint `<dir>/stepN` is a directory holding `train_state.pt`, which
is written under a temporary name and renamed into place, so a reader
never sees half a file.  `export_generator_pt` writes the MMPL inference
monolith `{'generator', 'generator_ema'}` with `model.`-prefixed fp32
tensors in the upstream WanModel layout, as the JAX export does.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

#: the file of a checkpoint directory
STATE_FILE = "train_state.pt"


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
    and each tensor of `template["model"]` must have its saved tensor's
    shape and dtype; a mismatch raises and names the tensor."""
    state = torch.load(os.path.join(path, STATE_FILE),
                       map_location=map_location, weights_only=True)
    if template is not None:
        missing = sorted(set(template) - set(state))
        if missing:
            raise KeyError(f"checkpoint {path} lacks {missing}")
        for name, like in template.get("model", {}).items():
            got = state["model"].get(name)
            if got is None or got.shape != like.shape \
                    or got.dtype != like.dtype:
                raise ValueError(
                    f"checkpoint {path}: model tensor {name!r} is "
                    f"{None if got is None else (tuple(got.shape), got.dtype)}"
                    f", expected {(tuple(like.shape), like.dtype)}")
    return state


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


def export_generator_pt(path: str, model: torch.nn.Module,
                        ema: Optional[Dict[str, torch.Tensor]], cfg) -> None:
    """Write `{'generator': ..., 'generator_ema': ...}` (the EMA only when
    given) with `model.`-prefixed fp32 tensors in the upstream layout: the
    `t2v_14B_8k.pt` format that `utils/checkpoint.load_mmpl_generator`
    (and the JAX package's) reads.  t2v configs only: the JAX export has
    no i2v leaves, so an i2v file would not load back."""
    if cfg.model_type != "t2v":
        raise NotImplementedError(
            f"export of a {cfg.model_type} DiT: the upstream export "
            f"(mmpl_tpu export_generator_pt) writes t2v leaves only")
    blob = {"generator": _upstream_state(dict(model.named_parameters()),
                                         cfg)}
    if ema is not None:
        blob["generator_ema"] = _upstream_state(ema, cfg)
    _save_atomic(blob, path)
