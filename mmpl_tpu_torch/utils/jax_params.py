"""Map the JAX package's parameter trees onto this package's state dicts.

The trees come in as nested dicts/lists of numpy arrays (bf16 arrays as
numpy's `bfloat16` extension type or any 2-byte view of it).  Conversions:

  * linear `kernel` [din, dout] -> `weight` [dout, din];
  * the DiT's stacked `blocks` leaves [L, ...] -> `blocks.<i>.*`;
  * conv `kernel` DHWIO -> OIDHW and HWIO -> OIHW;
  * int8 codes of a quantised tree (`kernel_q`, `kernel_w8`) -> `weight_q`,
    `weight_w8`, permuted as the float kernels are; their `scale` as it is.
    Such a tree loads into a model quantised the same way
    (`dit.quantize_params_mixed`, `vae.quantize_vae_decoder`);
  * fused (`self_attn.qkv`) and unfused (`self_attn.q/k/v`) self-attention
    both map one to one; build the DiT with the matching `fused` flag;
  * TAEHV's per-layer lists (`init_taehv_params`-style) -> the upstream
    `taew2_1.pth` names that `models.taehv.TAEHV` carries: a MemBlock's
    `c0/c1/c2` -> `conv.0/2/4`, a TPool / TGrow kernel -> `conv`;
  * the i2v DiT's extra leaves (`img_emb`, `k_img` / `v_img` /
    `norm_k_img`) map like the others; the CLIP visual tower, XLM-RoBERTa
    (its bare embedding tables -> `.weight`) and its head, and the whole
    XLMRobertaCLIP map onto `models.clip` / `models.xlm_roberta`;
  * the GAN head of the distillation trainer (`training.gan.GanHead`);
  * the JAX trainer's state (params, optax AdamW state, EMA shadow, step)
    -> a checkpoint of `utils/train_state_io` for the port's trainer.

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


#: JAX kernel names -> this package's weight names
_KERNELS = {"kernel": "weight", "kernel_q": "weight_q",
            "kernel_w8": "weight_w8"}


def _leaf(path: str, a) -> Tuple[str, torch.Tensor]:
    t = to_tensor(a)
    head, _, name = path.rpartition(".")
    if name not in _KERNELS:
        return path, t
    perm = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}[t.ndim]
    return f"{head}.{_KERNELS[name]}", t.permute(*perm).contiguous()


def _stacked_state(tree, num_layers: int) -> Dict[str, torch.Tensor]:
    """A tree whose `blocks` leaves are stacked [L, ...] -> `blocks.<i>.*`,
    the other leaves through `_leaf`."""
    state = {}
    for path, a in _walk({k: v for k, v in tree.items() if k != "blocks"}):
        k, t = _leaf(path, a)
        state[k] = t
    for path, a in _walk(tree["blocks"]):
        a = np.asarray(a)
        assert a.shape[0] == num_layers, (path, a.shape)
        for i in range(num_layers):
            k, t = _leaf(path, a[i])
            state[f"blocks.{i}.{k}"] = t
    return state


def dit_state_from_jax(tree, cfg) -> Dict[str, torch.Tensor]:
    """State dict of `models.dit.WanDiT` from `init_dit_params`-style
    params (stacked `blocks`, optionally `fuse_qkv_params`-fused; an i2v
    tree's `img_emb` and `k_img` / `v_img` / `norm_k_img` included)."""
    return _stacked_state(tree, cfg.num_layers)


def clip_visual_state_from_jax(tree, cfg: dict) -> Dict[str, torch.Tensor]:
    """State dict of `models.clip.CLIPVisual` from
    `init_clip_visual_params`-style params (the HWIO patch kernel ->
    OIHW)."""
    return _stacked_state(tree, cfg["num_layers"])


#: XLM-RoBERTa's bare embedding tables
_TABLES = ("token_embedding", "pos_embedding", "type_embedding")


def xlm_roberta_state_from_jax(tree, cfg: dict) -> Dict[str, torch.Tensor]:
    """State dict of `models.xlm_roberta.XLMRoberta` from
    `init_xlm_roberta_params`-style params."""
    state = _stacked_state(tree, cfg["num_layers"])
    for name in _TABLES:
        state[f"{name}.weight"] = state.pop(name)
    return state


def xlm_roberta_head_state_from_jax(tree) -> Dict[str, torch.Tensor]:
    """State dict of `models.xlm_roberta.XLMRobertaHead`."""
    return dict(_leaf(path, a) for path, a in _walk(tree))


def xlm_roberta_clip_state_from_jax(tree, vis_cfg: dict, text_cfg: dict
                                    ) -> Dict[str, torch.Tensor]:
    """State dict of `models.clip.XLMRobertaCLIP` from the
    `convert_xlm_roberta_clip` tree ({"visual", "textual", "head",
    "log_scale"})."""
    state = {"log_scale": to_tensor(tree["log_scale"])}
    for prefix, part in (
            ("visual", clip_visual_state_from_jax(tree["visual"], vis_cfg)),
            ("textual", xlm_roberta_state_from_jax(tree["textual"],
                                                   text_cfg)),
            ("head", xlm_roberta_head_state_from_jax(tree["head"]))):
        state.update({f"{prefix}.{k}": v for k, v in part.items()})
    return state


def train_state_from_jax(params, opt_state, ema, step: int, cfg,
                         optimizer: torch.optim.Optimizer,
                         model: torch.nn.Module) -> Dict[str, object]:
    """A `utils/train_state_io` checkpoint dict from the JAX trainer's
    state: `params`, the `optax.adamw` state (`opt_state[0]` holds `count`,
    `mu`, `nu`), the EMA shadow and the step.  `optimizer` (an AdamW over
    `model.parameters()`) gives the parameter order and the
    hyper-parameters.  No generator states: a run resumed from it draws
    from the seeds."""
    adam = opt_state[0]
    names = [n for n, _ in model.named_parameters()]
    mu = dit_state_from_jax(adam.mu, cfg)
    nu = dit_state_from_jax(adam.nu, cfg)
    count = float(np.asarray(adam.count))
    opt = optimizer.state_dict()
    opt["state"] = {i: {"step": torch.tensor(count),
                        "exp_avg": mu[n], "exp_avg_sq": nu[n]}
                    for i, n in enumerate(names)}
    return {"model": dit_state_from_jax(params, cfg), "optimizer": opt,
            "ema": dit_state_from_jax(ema, cfg), "step": int(step)}


def gan_head_state_from_jax(tree) -> Dict[str, torch.Tensor]:
    """State dict of `training.gan.GanHead` from `init_gan_head_params`-
    style params (the register tokens as they are, each `gan_blocks` entry
    -> `gan_blocks.<i>.*`)."""
    return dict(_leaf(path, a) for path, a in _walk(tree))


def vae_state_from_jax(tree) -> Dict[str, torch.Tensor]:
    """State dict of `models.vae.WanVAE` from `init_vae_params`-style
    params."""
    return dict(_leaf(path, a) for path, a in _walk(tree))


#: a MemBlock's JAX conv names -> its upstream nn.Sequential indices
_MEM_CONVS = {"c0": "conv.0", "c1": "conv.2", "c2": "conv.4", "skip": "skip"}


def taehv_state_from_jax(tree) -> Dict[str, torch.Tensor]:
    """State dict of `models.taehv.TAEHV` from `init_taehv_params`-style
    params ({"encoder": [...], "decoder": [...]}, one entry per layout
    row; conv kernels HWIO, the inverse of `convert_taehv`'s
    (2, 3, 1, 0) transpose)."""
    from ..models.taehv import DECODER_LAYOUT, ENCODER_LAYOUT
    state = {}
    for part, layout in (("encoder", ENCODER_LAYOUT),
                         ("decoder", DECODER_LAYOUT)):
        for i, (row, p) in enumerate(zip(layout, tree[part])):
            for path, a in _walk(p):
                head, _, leaf = path.rpartition(".")
                if row[0] == "mem":
                    head = _MEM_CONVS[head]
                elif row[0] in ("tpool", "tgrow"):
                    head = "conv"
                k, t = _leaf(f"{part}.{i}." + (f"{head}." if head else "")
                             + leaf, a)
                state[k] = t
    return state


def t5_state_from_jax(tree) -> Dict[str, torch.Tensor]:
    """State dict of `models.t5.T5Encoder` from `init_t5_params`-style
    params: the stacked `blocks` leaves [L, ...] -> `blocks.<i>.*`, the
    bare [din, dout] projections (`attn.q`, `ffn.gate`, ...) -> `.weight`
    [dout, din], `token_embedding` and `pos_embedding` -> `.weight`."""
    state = {"token_embedding.weight": to_tensor(tree["token_embedding"]),
             "norm.weight": to_tensor(tree["norm"]["weight"])}
    for path, a in _walk(tree["blocks"]):
        a = np.asarray(a)
        for i in range(a.shape[0]):
            t = to_tensor(a[i])
            if path.startswith(("attn.", "ffn.")):
                path_i, t = f"{path}.weight", t.T.contiguous()
            elif path == "pos_embedding":
                path_i = "pos_embedding.weight"
            else:
                path_i = path
            state[f"blocks.{i}.{path_i}"] = t
    return state
