"""Configuration: attribute dicts, model configs and the YAML run-config merge.

Port of `mmpl_tpu/core/config.py` (the JAX package's copy is not imported).
"""

from __future__ import annotations

import copy
from typing import Any, Mapping, Optional


class DotDict(dict):
    """dict with attribute access, recursively wrapping nested mappings."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            if isinstance(v, Mapping) and not isinstance(v, DotDict):
                self[k] = DotDict(v)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if isinstance(value, Mapping) and not isinstance(value, DotDict):
            value = DotDict(value)
        self[name] = value

    def __deepcopy__(self, memo):
        return DotDict({k: copy.deepcopy(v, memo) for k, v in self.items()})


def merge(base: Mapping, override: Mapping) -> DotDict:
    """Recursive dict merge; `override` wins (OmegaConf.merge semantics)."""
    out = DotDict(copy.deepcopy(dict(base)))
    for k, v in override.items():
        if (k in out and isinstance(out[k], Mapping)
                and isinstance(v, Mapping)):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_yaml(path: str) -> DotDict:
    import yaml
    with open(path) as f:
        return DotDict(yaml.safe_load(f) or {})


def load_config(config_path: str,
                default_path: Optional[str] = None) -> DotDict:
    """default ⊕ run config, like the reference's run scripts."""
    cfg = load_yaml(default_path) if default_path else DotDict()
    return merge(cfg, load_yaml(config_path))


_SHARED = dict(
    t5_model="umt5_xxl",
    t5_dtype="bfloat16",
    text_len=512,
    param_dtype="bfloat16",
    num_train_timesteps=1000,
    sample_fps=16,
    sample_neg_prompt=(
        "色调艳丽，过曝，静态，细节模糊不清，字幕，风格，作品，画作，画面，静止，整体发灰，最差质量，"
        "低质量，JPEG压缩残留，丑陋的，残缺的，多余的手指，画得不好的手部，画得不好的脸部，畸形的，"
        "毁容的，形态畸形的肢体，手指融合，静止不动的画面，杂乱的背景，三条腿，背景人很多，倒着走"),
    vae_checkpoint="Wan2.1_VAE.pth",
    vae_stride=(4, 8, 8),
    patch_size=(1, 2, 2),
    freq_dim=256,
    window_size=(-1, -1),
    qk_norm=True,
    cross_attn_norm=True,
    eps=1e-6,
    text_dim=4096,
    in_dim=16,
    out_dim=16,
)

T2V_14B = DotDict(_SHARED, name="t2v-14B", model_type="t2v",
                  dim=5120, ffn_dim=13824, num_heads=40, num_layers=40,
                  t5_checkpoint="models_t5_umt5-xxl-enc-bf16.pth",
                  t5_tokenizer="google/umt5-xxl")

T2V_1_3B = DotDict(_SHARED, name="t2v-1.3B", model_type="t2v",
                   dim=1536, ffn_dim=8960, num_heads=12, num_layers=30,
                   t5_checkpoint="models_t5_umt5-xxl-enc-bf16.pth",
                   t5_tokenizer="google/umt5-xxl")

I2V_14B = DotDict(_SHARED, name="i2v-14B", model_type="i2v",
                  dim=5120, ffn_dim=13824, num_heads=40, num_layers=40,
                  in_dim=36,  # latent(16) + mask(4) + cond latent(16)
                  t5_checkpoint="models_t5_umt5-xxl-enc-bf16.pth",
                  t5_tokenizer="google/umt5-xxl",
                  clip_checkpoint=(
                      "models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth"),
                  clip_tokenizer="xlm-roberta-large")

T2I_14B = DotDict(copy.deepcopy(T2V_14B), name="t2i-14B")

WAN_CONFIGS = {
    "t2v-14B": T2V_14B,
    "t2v-1.3B": T2V_1_3B,
    "i2v-14B": I2V_14B,
    "t2i-14B": T2I_14B,
}

SIZE_CONFIGS = {
    "720*1280": (720, 1280),
    "1280*720": (1280, 720),
    "480*832": (480, 832),
    "832*480": (832, 480),
    "1024*1024": (1024, 1024),
}

MAX_AREA_CONFIGS = {
    "720*1280": 720 * 1280,
    "1280*720": 1280 * 720,
    "480*832": 480 * 832,
    "832*480": 832 * 480,
}

SUPPORTED_SIZES = {
    "t2v-14B": ("720*1280", "1280*720", "480*832", "832*480"),
    "t2v-1.3B": ("480*832", "832*480"),
    "i2v-14B": ("720*1280", "1280*720", "480*832", "832*480"),
    "t2i-14B": tuple(SIZE_CONFIGS.keys()),
}


def tiny_test_config(model_type: str = "t2v") -> DotDict:
    """A miniature DiT config for unit tests (structure-preserving)."""
    return DotDict(_SHARED, name="tiny", model_type=model_type,
                   dim=96, ffn_dim=256, num_heads=4, num_layers=2,
                   text_dim=64, text_len=16, freq_dim=32,
                   in_dim=36 if model_type == "i2v" else 16)
