"""Datasets and the batch iterator of the trainer's `--data-dir`.

Port of `mmpl_tpu/data/datasets.py` (numpy only; the port keeps its own
copy): plain-Python iterables yielding numpy, batched by
`batch_iterator`.  The item schemas, the `.npz` shard layout
(`latents` [N, F, C, H, W], `prompt_embeds` [N, T, D], optional
`prompts`) and the LMDB layout (`{key}_{shape|data}` entries, gated on
the optional `lmdb` package) are the JAX package's, so shards written
by either package are read by the other.

`batch_iterator` shuffles with numpy's `default_rng(seed)` as JAX's does:
for the same seed it yields the same indices in the same order.  It also
takes `skip`, the number of batches to pass over without loading their
items, which is how the trainer's `--resume` puts a fresh iterator where
the checkpointed one was.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

try:
    import lmdb
    _HAS_LMDB = True
except ImportError:
    _HAS_LMDB = False


def cycle(iterable):
    while True:
        for x in iterable:
            yield x


class TextDataset:
    """One prompt per line, with an optional parallel file of extended
    prompts."""

    def __init__(self, prompt_path: str,
                 extended_prompt_path: Optional[str] = None):
        with open(prompt_path, encoding="utf-8") as f:
            self.prompt_list = [line.rstrip("\n") for line in f
                                if line.strip()]
        self.extended_prompt_list: Optional[List[str]] = None
        if extended_prompt_path:
            with open(extended_prompt_path, encoding="utf-8") as f:
                self.extended_prompt_list = [line.rstrip("\n") for line in f
                                             if line.strip()]
            assert len(self.extended_prompt_list) == len(self.prompt_list)

    def __len__(self):
        return len(self.prompt_list)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        batch = {"prompts": self.prompt_list[idx], "idx": idx}
        if self.extended_prompt_list is not None:
            batch["extended_prompts"] = self.extended_prompt_list[idx]
        return batch


class TextImagePairDataset:
    """Images and prompts from a crop-info json: entries {"image_name",
    "caption" or "prompt", optional "crop": [x0, y0, x1, y1]}.  Yields
    CHW float32 in [-1, 1] (PIL, imported when an item is read)."""

    def __init__(self, data_dir: str, metadata_path: str,
                 height: int = 480, width: int = 832):
        self.data_dir = data_dir
        self.height, self.width = height, width
        with open(metadata_path, encoding="utf-8") as f:
            meta = json.load(f)
        self.items = meta if isinstance(meta, list) else meta.get("data", [])

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        from PIL import Image
        item = self.items[idx]
        path = os.path.join(self.data_dir,
                            item.get("image_name") or item["image"])
        img = Image.open(path).convert("RGB")
        if "crop" in item:
            img = img.crop(tuple(item["crop"]))
        img = img.resize((self.width, self.height), Image.BICUBIC)
        arr = np.asarray(img, np.float32) / 127.5 - 1.0
        return {"image": arr.transpose(2, 0, 1),
                "prompts": item.get("caption") or item.get("prompt", ""),
                "idx": idx}


class _NpzShards:
    """Items of the `.npz` shards of a directory, by global index; one
    shard is kept loaded at a time."""

    count_key = "latents"

    def __init__(self, shard_dir: str):
        self.files = sorted(
            os.path.join(shard_dir, f) for f in os.listdir(shard_dir)
            if f.endswith(".npz"))
        self._index: List[tuple] = []
        self._cache: Dict[str, Any] = {}
        for f in self.files:
            with np.load(f, allow_pickle=True) as z:
                n = z[self.count_key].shape[0]
            self._index.extend((f, i) for i in range(n))

    def __len__(self):
        return len(self._index)

    def _load(self, path):
        if path not in self._cache:
            self._cache.clear()
            self._cache[path] = dict(np.load(path, allow_pickle=True))
        return self._cache[path]


class TensorDictDataset(_NpzShards):
    """Precomputed latents over `.npz` shards: items {"latents"
    [F, C, H, W], "prompt_embeds" [T, D], optional "prompts"}."""

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        path, i = self._index[idx]
        z = self._load(path)
        out = {"latents": z["latents"][i],
               "prompt_embeds": z["prompt_embeds"][i]}
        if "prompts" in z:
            out["prompts"] = str(z["prompts"][i])
        return out


# ---------------------------------------------------------------------------
# LMDB-backed datasets (the upstream layout)
# ---------------------------------------------------------------------------

def get_array_shape_from_lmdb(env, array_name: str) -> tuple:
    """`{name}_shape` stores str(tuple)."""
    with env.begin() as txn:
        raw = txn.get(f"{array_name}_shape".encode())
    return tuple(int(x) for x in
                 raw.decode().strip("()").split(",") if x.strip())


def retrieve_row_from_lmdb(env, array_name: str, dtype, shape: tuple,
                           row_index: int) -> np.ndarray:
    """Row entries `{name}_{idx}_data`."""
    with env.begin() as txn:
        raw = txn.get(f"{array_name}_{row_index}_data".encode())
    arr = np.frombuffer(raw, dtype=dtype)
    return arr.reshape(shape).copy()


def _open_lmdb(path: str):
    if not _HAS_LMDB:
        raise ImportError("lmdb is not available in this environment")
    return lmdb.open(path, readonly=True, lock=False, readahead=False,
                     meminit=False)


class ODERegressionLMDBDataset:
    """ODE-trajectory pairs: `ode_latent` [N, S+1, F, C, H, W] (fp16 on
    disk, fp32 items) and `prompts`."""

    def __init__(self, data_path: str, max_pair: int = int(1e8)):
        self.env = _open_lmdb(data_path)
        self.latents_shape = get_array_shape_from_lmdb(self.env,
                                                       "ode_latent")
        self.max_pair = max_pair

    def __len__(self):
        return min(self.latents_shape[0], self.max_pair)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        latents = retrieve_row_from_lmdb(
            self.env, "ode_latent", np.float16, self.latents_shape[1:], idx)
        with self.env.begin() as txn:
            prompt = txn.get(f"prompts_{idx}_data".encode()).decode()
        return {"ode_latent": latents.astype(np.float32), "prompts": prompt}


class ShardingLMDBDataset:
    """Latents over several LMDB shards (one sub-directory each)."""

    def __init__(self, data_path: str, max_pair: int = int(1e8)):
        if not _HAS_LMDB:
            raise ImportError("lmdb is not available in this environment")
        self.envs, self.shapes, self.offsets = [], [], [0]
        for name in sorted(os.listdir(data_path)):
            p = os.path.join(data_path, name)
            if not os.path.isdir(p):
                continue
            env = _open_lmdb(p)
            shape = get_array_shape_from_lmdb(env, "latents")
            self.envs.append(env)
            self.shapes.append(shape)
            self.offsets.append(self.offsets[-1] + shape[0])
        self.max_pair = max_pair

    def __len__(self):
        return min(self.offsets[-1], self.max_pair)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        shard = int(np.searchsorted(self.offsets, idx, side="right")) - 1
        local = idx - self.offsets[shard]
        env, shape = self.envs[shard], self.shapes[shard]
        latents = retrieve_row_from_lmdb(env, "latents", np.float16,
                                         shape[1:], local)
        with env.begin() as txn:
            prompt = txn.get(f"prompts_{local}_data".encode()).decode()
        return {"latents": latents.astype(np.float32), "prompts": prompt}


def batch_iterator(dataset, batch_size: int, shuffle: bool = True,
                   seed: int = 0, drop_last: bool = True, skip: int = 0
                   ) -> Iterator[Dict[str, Any]]:
    """Endless batches of `dataset`, each dict field stacked (numpy arrays)
    or listed (anything else); reshuffled at each pass with
    `default_rng(seed)`.  The first `skip` batches are passed over without
    loading their items."""
    starts = range(0, len(dataset) - (batch_size - 1 if drop_last else 0),
                   batch_size)
    if not starts:
        raise ValueError(f"{len(dataset)} items make no batch of "
                         f"{batch_size}")
    rng = np.random.default_rng(seed)
    order = np.arange(len(dataset))
    while True:
        if shuffle:
            rng.shuffle(order)
        for s in starts:
            if skip:
                skip -= 1
                continue
            items = [dataset[int(i)] for i in order[s:s + batch_size]]
            batch: Dict[str, Any] = {}
            for k in items[0]:
                vals = [it[k] for it in items]
                batch[k] = (np.stack(vals)
                            if isinstance(vals[0], np.ndarray) else vals)
            yield batch
