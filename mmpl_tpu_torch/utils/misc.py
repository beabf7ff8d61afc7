"""Seeding and the merge of per-step dicts.

Port of `mmpl_tpu/utils/misc.py`: `set_seed` seeds Python's `random`,
numpy and torch (every device) and returns a `torch.Generator` seeded
the same, where the JAX package returns a PRNG key.
"""

from __future__ import annotations

import random
from typing import Dict, List

import numpy as np
import torch


def set_seed(seed: int) -> torch.Generator:
    """Seed `random`, numpy and torch; a (CPU) generator from the same
    seed."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def merge_dict_list(dict_list: List[Dict]) -> Dict:
    """Merge a list of step dicts: arrays and tensors of one or more
    dimensions are concatenated on axis 0 (numpy or torch, as the first
    entry), anything else is kept from the first entry."""
    if not dict_list:
        return {}
    out: Dict = {}
    for key in dict_list[0]:
        vals = [d[key] for d in dict_list]
        first = vals[0]
        if isinstance(first, torch.Tensor) and first.ndim > 0:
            out[key] = torch.cat([torch.as_tensor(v) for v in vals], dim=0)
        elif getattr(first, "ndim", 0) > 0:
            out[key] = np.concatenate([np.asarray(v) for v in vals], axis=0)
        else:
            out[key] = first
    return out
