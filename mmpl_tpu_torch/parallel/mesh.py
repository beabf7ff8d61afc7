"""Process groups and device meshes.

Port of `mmpl_tpu/parallel/mesh.py` onto `torch.distributed`: one process
per card, NCCL between cards and gloo on the CPU, and a
`torch.distributed.device_mesh.DeviceMesh` with named dims (`dp`, `fsdp`,
`tp`, `sp`, `ring`, ...) in place of `jax.sharding.Mesh`.  A mesh's ranks
are processes, not devices, so every process builds every mesh (the
groups are made collectively) and runs the ranks it owns.  The
sequence-parallel path takes such a mesh (`parallel/collectives.as_mesh`)
or the in-process `collectives.LocalMesh`, which holds every rank on one
card.
"""

from __future__ import annotations

import math
import os
import re
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn


def _env_int(*names: str) -> Optional[int]:
    for n in names:
        if os.environ.get(n):
            return int(os.environ[n])
    return None


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """The multi-process entry (the reference's `launch_distributed_job`,
    `MMPL_t2v/utils/distributed.py:75-89`, a tcp:// rendezvous).

    Arguments fall back to `COORDINATOR_ADDRESS` / `NUM_PROCESSES` /
    `PROCESS_ID`, as in the JAX package, then to torchrun's `MASTER_ADDR`
    (+ `MASTER_PORT`) / `WORLD_SIZE` / `RANK`, PyTorch's names for the
    same rendezvous.  With nothing set it is a single-process no-op and
    returns False; with the default group already initialised it returns
    True.  Otherwise it initialises the default process group,
    NCCL where a card is available and gloo on the CPU, and returns True;
    `MMPL_DIST_BACKEND` names another, as gloo for ranks that share one
    card, which NCCL refuses.  Where a card is available
    each process takes card LOCAL_RANK, else its process id modulo the
    cards.  Call it before any other use of the groups."""
    if dist.is_initialized():
        return True
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("PROCESS_ID", "RANK")
    if coordinator is None and num_processes is None and process_id is None:
        return False
    missing = [name for name, v in (("coordinator", coordinator),
                                    ("num_processes", num_processes),
                                    ("process_id", process_id)) if v is None]
    if missing:
        raise ValueError(f"init_distributed: {', '.join(missing)} not given "
                         f"(nor in the environment); torch.distributed "
                         f"needs all three")
    backend = os.environ.get("MMPL_DIST_BACKEND") or (
        "nccl" if torch.cuda.is_available() else "gloo")
    if torch.cuda.is_available():
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(local if local is not None
                              else process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    return True


def _largest_pow2_divisor(n: int, cap: int) -> int:
    d = 1
    while d * 2 <= cap and n % (d * 2) == 0:
        d *= 2
    return d


def make_mesh(shape: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence[int]] = None):
    """A DeviceMesh over the ranks `devices` (default: every rank of the
    default group); the default shape folds them into (dp, fsdp, tp),
    fsdp-major as in the JAX package.  shape: ordered {name: size} whose
    sizes multiply to at most len(devices); the first that many ranks
    form the mesh.  Needs `init_distributed` (a world of one process
    included)."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "init_distributed first")
    ranks = list(devices if devices is not None
                 else range(dist.get_world_size()))
    if shape is None:
        fsdp = _largest_pow2_divisor(len(ranks), cap=8)
        shape = {"dp": len(ranks) // fsdp, "fsdp": fsdp, "tp": 1}
    need = math.prod(shape.values())
    if need > len(ranks):
        raise ValueError(f"mesh {shape} needs {need} ranks, has "
                         f"{len(ranks)}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type,
                      torch.tensor(ranks[:need]).reshape(
                          tuple(shape.values())),
                      mesh_dim_names=tuple(shape))


def make_stage_meshes(n_stages: int, shape: Optional[Dict[str, int]] = None,
                      devices: Optional[Sequence[int]] = None) -> List:
    """Split the ranks into `n_stages` equal sub-meshes, one per chunk
    pipeline stage (the reference's one pipeline per GPU, generalised to
    one per sub-mesh).  Every process builds all of them."""
    ranks = list(devices if devices is not None
                 else range(dist.get_world_size()))
    if len(ranks) % n_stages:
        raise ValueError(f"{len(ranks)} ranks do not split into {n_stages} "
                         f"stages")
    per = len(ranks) // n_stages
    return [make_mesh(shape, devices=ranks[i * per:(i + 1) * per])
            for i in range(n_stages)]


# ---------------------------------------------------------------------------
# Tensor parallelism over heads and the ffn (Megatron), fsdp over the
# contraction dim, dp over the batch
# ---------------------------------------------------------------------------

#: a block's projections: column-parallel (their output rows split over
#: tp: heads, ffn units) and row-parallel (their input columns split, the
#: partial products summed across tp), as Megatron splits them; the fused
#: qkv of the sampling pipelines or the trainer's q / k / v
_COLUMN = ("self_attn.qkv", "self_attn.q", "self_attn.k", "self_attn.v",
           "cross_attn.q", "cross_attn.k", "cross_attn.v", "ffn.fc1")
_ROW = ("self_attn.o", "cross_attn.o", "ffn.fc2")
#: the QK-norms, whose weights split with the heads and whose sum of
#: squares is reduced across tp (`dit.rms_norm`)
_NORMS = ("self_attn.norm_q", "self_attn.norm_k", "cross_attn.norm_q",
          "cross_attn.norm_k")
#: a projection's weight: float, or the int8 codes of a `QuantLinear`
_WEIGHTS = ("weight", "weight_q", "weight_w8")

_TP_NAME = re.compile(
    r"(?:^|\.)blocks\.\d+\.((?:self_attn|cross_attn|ffn)\.\w+)\."
    r"(weight|weight_q|weight_w8|bias|scale)$")


def tp_split_dim(name: str) -> Optional[int]:
    """The dim along which tp splits the tensor of a DiT's parameter (or
    int8 code, scale) `name` (a state-dict name, perhaps prefixed): 0 for
    a column-parallel projection's rows (weight, bias, scale) and the
    QK-norms, 1 for a row-parallel projection's weight; None for what
    every tp rank holds whole."""
    m = _TP_NAME.search(name)
    if m is None:
        return None
    path, leaf = m.groups()
    if path in _NORMS or path in _COLUMN:
        return 0
    if path in _ROW and leaf in _WEIGHTS:
        return 1
    return None


def mesh_size(mesh, name: str) -> int:
    """The size of a mesh dim (a DeviceMesh, `collectives.ProcessMesh` or
    `LocalMesh`), 1 where the mesh has no such dim."""
    names = tuple(getattr(mesh, "names", None) or mesh.mesh_dim_names)
    if name not in names:
        return 1
    sizes = getattr(mesh, "sizes", None) or tuple(mesh.mesh.shape)
    return int(sizes[names.index(name)])


def _group(mesh, name: str):
    return mesh.get_group(name) if mesh_size(mesh, name) > 1 else None


def _slice(t: torch.Tensor, dim: int, parts: int, index: int
           ) -> torch.Tensor:
    return t.chunk(parts, dim)[index].contiguous()


def _slice_rows(t: torch.Tensor, path: str, tp: int, rank: int
                ) -> torch.Tensor:
    """This rank's output rows of a column-parallel projection's tensor:
    the fused qkv's q, k and v each sliced, others contiguously."""
    if path == "self_attn.qkv":
        return torch.cat([_slice(c, 0, tp, rank) for c in t.chunk(3, 0)])
    return _slice(t, 0, tp, rank)


def _projections(blk):
    """(path, module, name of its weight or int8 codes) of each of the
    block's projections in _COLUMN and _ROW (the fused qkv or q / k / v,
    whichever it has)."""
    from ..ops.quant import QuantLinear
    for path in _COLUMN + _ROW:
        try:
            lin = blk.get_submodule(path)
        except AttributeError:
            continue
        yield path, lin, (lin.code_name if isinstance(lin, QuantLinear)
                          else "weight")


@torch.no_grad()
def _shard_tp(model, tp: int, rank: int) -> None:
    """Megatron's split of every block of `model`, in place: the
    column-parallel projections keep this rank's output rows (weight or
    int8 codes, bias, scale), the row-parallel ones its input columns
    (their bias and scale whole), the QK-norms this rank's heads."""
    def put(mod, name, t):
        old = getattr(mod, name)
        if isinstance(old, nn.Parameter):
            t = nn.Parameter(t, requires_grad=old.requires_grad)
        setattr(mod, name, t)

    for blk in model.blocks:
        for path, lin, wname in _projections(blk):
            w = getattr(lin, wname)
            if path in _ROW:
                put(lin, wname, _slice(w, 1, tp, rank))
                continue
            put(lin, wname, _slice_rows(w, path, tp, rank))
            for name in ("bias", "scale"):
                if getattr(lin, name, None) is not None:
                    put(lin, name, _slice_rows(getattr(lin, name), path, tp,
                                               rank))
        for path in _NORMS:
            norm = blk.get_submodule(path)
            put(norm, "weight", _slice(norm.weight, 0, tp, rank))


def _check_tp(model, tp: int, num_heads: int, what: str) -> None:
    blk0 = model.blocks[0]
    fc1 = blk0.ffn.fc1
    ffn = (fc1.codes if hasattr(fc1, "codes") else fc1.weight).shape[0]
    if num_heads % tp or ffn % tp:
        raise ValueError(f"tp = {tp} does not divide {num_heads} heads "
                         f"and the ffn")
    if hasattr(blk0.cross_attn, "k_img"):
        raise ValueError(f"{what} takes a t2v DiT")


class InferenceSharding:
    """A sampling pipeline's view of its `mesh` (a DeviceMesh or
    `collectives.ProcessMesh` with some of dp, fsdp, tp; None: one
    device).  At construction the fused model, float or int8
    (`dit.apply_quantize` runs first, on the whole weights, the same on
    every rank), is sharded (`shard_params_for_inference`) and `cfg`
    gains its `sharding` (`dit.LayerSharding`), so that the layers take
    this rank's heads, reduce over tp and gather over fsdp; an int8 cache
    then holds this rank's heads beside scales that span all of them
    (`fps_dit.init_kv_cache`).  `rows` takes this process's dp rows of a
    batch (its share of the KV cache and context K/V too) and `gather`
    joins a forward's rows across dp."""

    def __init__(self, cfg, model, mesh):
        self.mesh, self.dp, self.dp_rank = None, None, 0
        self.cfg, self.model = cfg, model
        if mesh is None:
            return
        from ..core.config import DotDict
        from .collectives import as_mesh
        self.mesh = as_mesh(mesh)
        self.cfg = DotDict(cfg, sharding=shard_params_for_inference(
            model, self.mesh, cfg.num_heads))
        if mesh_size(self.mesh, "dp") > 1:
            self.dp = self.mesh.get_group("dp")
            self.dp_rank = self.mesh.coordinate("dp")

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This process's rows of batch-first x (all of them without dp)."""
        return x if self.dp is None else x.chunk(self.dp.size, 0)[
            self.dp_rank]

    def num_rows(self, n: int) -> int:
        return n if self.dp is None else n // self.dp.size

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every process's rows of x, in dp order."""
        return x if self.dp is None else self.dp.all_gather(x, 0)


@torch.no_grad()
def shard_params_for_inference(model, mesh, num_heads: int):
    """Shard a fused-qkv t2v WanDiT, float or int8, over `mesh`'s (fsdp,
    tp) dims, in place (JAX `shard_params_for_inference` with
    `dit_param_shardings`), and return the `dit.LayerSharding` its layers
    then run with.

    tp (Megatron, `_shard_tp`): the fused qkv, the cross-attention q / k
    / v and fc1 keep this rank's heads / ffn units (rows: weight or int8
    codes, bias, scale), o and fc2 its input columns (codes too; scale
    and bias whole) and sum the partial products across tp (`linear`'s
    group; int32 accumulators for W8A8); the QK-norm weights keep this
    rank's heads and reduce their sum of squares across tp (`rms_norm`'s
    group).  fsdp: every block projection's weight (or codes) keeps 1/fsdp
    of its input columns, gathered before the block runs (`dit.run_block`'s
    unshard).  Embeddings, norms, modulations and the head stay whole."""
    from ..models.dit import LayerSharding
    from .collectives import as_mesh
    mesh = as_mesh(mesh)
    tp, fsdp = mesh_size(mesh, "tp"), mesh_size(mesh, "fsdp")
    _check_tp(model, tp, num_heads, "sharded inference")
    if not model.blocks[0].self_attn.fused:
        raise ValueError("sharded inference takes a fused-qkv t2v DiT")
    tp_group, fsdp_group = _group(mesh, "tp"), _group(mesh, "fsdp")
    if tp_group is not None:
        _shard_tp(model, tp, mesh.coordinate("tp"))
    fsdp_names = set()
    if fsdp_group is not None:
        rank_fsdp = mesh.coordinate("fsdp")
        for blk in model.blocks:
            for path, lin, wname in _projections(blk):
                w = getattr(lin, wname)
                if w.shape[1] % fsdp:
                    continue
                w = _slice(w, 1, fsdp, rank_fsdp)
                setattr(lin, wname, nn.Parameter(w, requires_grad=False)
                        if wname == "weight" else w)
                fsdp_names.add(f"{path}.{wname}")
    unshard = None
    if fsdp_names:
        def unshard(blk):
            held = dict(blk.named_parameters())
            held.update(blk.named_buffers())
            return {n: fsdp_group.all_gather(t, 1) if n in fsdp_names else t
                    for n, t in held.items()}
    return LayerSharding(tp, tp_group, unshard)


# ---------------------------------------------------------------------------
# Sharded training: tp over heads and the ffn, FSDP over fsdp, replicated
# over dp
# ---------------------------------------------------------------------------

def shard_for_training(model, mesh, num_heads: Optional[int] = None):
    """Shard a t2v WanDiT for training over a DeviceMesh with some of dp,
    fsdp and tp, in place, and return the `dit.LayerSharding` its training
    forwards run with (in `cfg.sharding`).

    tp: each block split as `shard_params_for_inference` splits it
    (`_shard_tp`: Megatron's column- and row-parallel projections and
    QK-norms), the slices plain tensors of this rank; the layers then move
    activations and gradients with `column` / `linear` / `rms_norm` over
    the tp group.  Then FSDP2 (`fully_shard`) over the (dp, fsdp)
    sub-mesh: each block an FSDP unit, the root holding the embeddings and
    the head; replicated over dp and sharded over fsdp (HSDP).  The
    parameters become DTensors over that sub-mesh; the layer functions run
    through `Block.forward` / `WanDiT.forward`, whose hooks gather a
    unit's parameters before it runs and reduce-scatter its gradients
    (their mean over the sub-mesh's ranks) after its backward.  A tp mesh
    whose (dp, fsdp) has one rank keeps plain tensors: nothing to shard,
    and no collective over a group of one.  num_heads: the model's heads
    (cfg.num_heads), needed with tp."""
    from ..models.dit import WHOLE, LayerSharding
    from .collectives import as_mesh
    try:
        from torch.distributed.fsdp import fully_shard
    except ImportError:           # torch releases before 2.6
        from torch.distributed._composable.fsdp import fully_shard
    names = tuple(mesh.mesh_dim_names)
    tp = mesh_size(mesh, "tp")
    sharding = WHOLE
    if tp > 1:
        if num_heads is None:
            raise ValueError("shard_for_training over tp needs num_heads")
        _check_tp(model, tp, num_heads, "tensor-parallel training")
        pm = as_mesh(mesh)
        _shard_tp(model, tp, pm.coordinate("tp"))
        sharding = LayerSharding(tp, pm.get_group("tp"), None)
    data = tuple(n for n in names if n in ("dp", "fsdp"))
    if not data or (tp > 1 and math.prod(mesh_size(mesh, n)
                                         for n in data) == 1):
        return sharding
    sub = mesh if data == names else mesh[data]
    for blk in model.blocks:
        fully_shard(blk, mesh=sub)
    fully_shard(model, mesh=sub)
    return sharding


def gather_tp(name: str, t: torch.Tensor, group) -> torch.Tensor:
    """The whole tensor of parameter `name` from this rank's tp slice `t`
    (`tp_split_dim`; a collective over the tp `group`, None for tp = 1);
    what tp does not split, as it is."""
    dim = tp_split_dim(name)
    if group is None or dim is None:
        return t
    if ".qkv." in name:
        return torch.cat([group.all_gather(c.contiguous(), 0)
                          for c in t.chunk(3, 0)])
    return group.all_gather(t.contiguous(), dim)
