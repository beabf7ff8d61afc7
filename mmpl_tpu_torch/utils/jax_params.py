"""Map the JAX package's parameter trees onto this package's state dicts.

The trees come in as nested dicts/lists of numpy arrays (bf16 arrays as
numpy's `bfloat16` extension type or any 2-byte view of it).  Conversions:

  * linear `kernel` [din, dout] -> `weight` [dout, din];
  * the DiT's stacked `blocks` leaves [L, ...] -> `blocks.<i>.*`;
  * conv `kernel` DHWIO -> OIDHW and HWIO -> OIHW;
  * fused (`self_attn.qkv`) and unfused (`self_attn.q/k/v`) self-attention
    both map one to one; build the DiT with the matching `fused` flag.

This module reads numpy only; it never imports the JAX package.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch


def to_tensor(a) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")      # writable, contiguous
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _walk(tree, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _leaf(path: str, a) -> Tuple[str, torch.Tensor]:
    t = to_tensor(a)
    head, _, name = path.rpartition(".")
    if name != "kernel":
        return path, t
    perm = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}[t.ndim]
    return f"{head}.weight", t.permute(*perm).contiguous()


def dit_state_from_jax(tree, cfg) -> Dict[str, torch.Tensor]:
    """State dict of `models.dit.WanDiT` from `init_dit_params`-style
    params (stacked `blocks`, optionally `fuse_qkv_params`-fused)."""
    state = {}
    for path, a in _walk({k: v for k, v in tree.items() if k != "blocks"}):
        k, t = _leaf(path, a)
        state[k] = t
    for path, a in _walk(tree["blocks"]):
        a = np.asarray(a)
        assert a.shape[0] == cfg.num_layers, (path, a.shape)
        for i in range(cfg.num_layers):
            k, t = _leaf(path, a[i])
            state[f"blocks.{i}.{k}"] = t
    return state


def vae_state_from_jax(tree) -> Dict[str, torch.Tensor]:
    """State dict of `models.vae.WanVAE` from `init_vae_params`-style
    params."""
    return dict(_leaf(path, a) for path, a in _walk(tree))
