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
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist


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
    NCCL where a card is available (each process on card LOCAL_RANK, else
    its process id modulo the cards) and gloo on the CPU, and returns True.
    Call it before any other use of the groups."""
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
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
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
# Sharded inference: tensor parallelism over heads and the ffn, fsdp over
# the contraction dim, dp over the CFG pair
# ---------------------------------------------------------------------------

#: a block's projections: column-parallel (their output rows split over
#: tp: heads, ffn units) and row-parallel (their input columns split, the
#: partial products summed across tp), as Megatron splits them
_COLUMN = ("self_attn.qkv", "cross_attn.q", "cross_attn.k", "cross_attn.v",
           "ffn.fc1")
_ROW = ("self_attn.o", "cross_attn.o", "ffn.fc2")
#: the QK-norms, whose weights split with the heads and whose sum of
#: squares is reduced across tp (`dit.rms_norm`)
_NORMS = ("self_attn.norm_q", "self_attn.norm_k", "cross_attn.norm_q",
          "cross_attn.norm_k")


def mesh_size(mesh, name: str) -> int:
    """The size of a mesh dim, 1 where the mesh has no such dim."""
    return mesh.size(name) if name in mesh.names else 1


def _group(mesh, name: str):
    return mesh.get_group(name) if mesh_size(mesh, name) > 1 else None


def _slice(t: torch.Tensor, dim: int, parts: int, index: int
           ) -> torch.Tensor:
    return t.chunk(parts, dim)[index].contiguous()


class InferenceSharding:
    """A sampling pipeline's view of its `mesh` (a DeviceMesh or
    `collectives.ProcessMesh` with some of dp, fsdp, tp; None: one
    device).  At construction the fused model is sharded
    (`shard_params_for_inference`) and `cfg` gains its `sharding`
    (`dit.LayerSharding`), so that the layers take this rank's heads,
    reduce over tp and gather over fsdp; then `rows` takes this process's dp
    rows of a batch (its share of the KV cache and context K/V too) and
    `gather` joins a forward's rows across dp.  int8 projections, and an
    int8 cache over tp (its per-token scale spans the heads), are refused
    under a mesh."""

    def __init__(self, cfg, model, mesh, quantize=None,
                 quantize_cache: bool = False):
        self.mesh, self.dp, self.dp_rank = None, None, 0
        self.cfg, self.model = cfg, model
        if mesh is None:
            return
        from ..core.config import DotDict
        from .collectives import as_mesh
        self.mesh = as_mesh(mesh)
        tp = mesh_size(self.mesh, "tp")
        if quantize or (quantize_cache and tp > 1):
            raise NotImplementedError(
                "int8 projections, or an int8 cache over tp, under a mesh "
                "are not ported (ROADMAP.md Queue 1)")
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
    """Shard a fused-qkv t2v WanDiT over `mesh`'s (fsdp, tp) dims, in
    place (JAX `shard_params_for_inference` with `dit_param_shardings`),
    and return the `dit.LayerSharding` its layers then run with.

    tp (Megatron): the fused qkv, the cross-attention q / k / v and fc1
    keep this rank's heads / ffn units (rows), o and fc2 its input columns
    and sum the partial products across tp (`linear`'s group); the
    QK-norm weights keep this rank's heads and reduce their sum of squares
    across tp (`rms_norm`'s group).  fsdp: every block projection's weight
    keeps 1/fsdp of its input columns, gathered before the block runs
    (`dit.run_block`'s unshard).  Embeddings, norms, modulations and the
    head stay whole."""
    from ..models.dit import LayerSharding
    from ..ops.quant import QuantLinear
    from .collectives import as_mesh
    mesh = as_mesh(mesh)
    tp, fsdp = mesh_size(mesh, "tp"), mesh_size(mesh, "fsdp")
    if num_heads % tp or model.blocks[0].ffn.fc1.weight.shape[0] % tp:
        raise ValueError(f"tp = {tp} does not divide {num_heads} heads "
                         f"and the ffn")
    tp_group, fsdp_group = _group(mesh, "tp"), _group(mesh, "fsdp")
    rank_tp = mesh.coordinate("tp") if tp_group else 0
    rank_fsdp = mesh.coordinate("fsdp") if fsdp_group else 0
    blk0 = model.blocks[0]
    if not blk0.self_attn.fused or hasattr(blk0.cross_attn, "k_img"):
        raise ValueError("sharded inference takes a fused-qkv t2v DiT")
    param = lambda t: torch.nn.Parameter(t, requires_grad=False)
    sub = lambda blk, path: blk.get_submodule(path)
    fsdp_names = set()
    for blk in model.blocks:
        for path in _COLUMN + _ROW:
            lin = sub(blk, path)
            if isinstance(lin, QuantLinear):
                raise ValueError("sharded inference takes float "
                                 "projections (quantize after sharding is "
                                 "not ported)")
            w = lin.weight
            if tp_group is not None and path in _ROW:
                w = _slice(w, 1, tp, rank_tp)
            elif tp_group is not None and path == "self_attn.qkv":
                w = torch.cat([_slice(c, 0, tp, rank_tp)
                               for c in w.chunk(3, 0)])
                lin.bias = param(torch.cat([
                    _slice(c, 0, tp, rank_tp) for c in lin.bias.chunk(3)]))
            elif tp_group is not None:
                w = _slice(w, 0, tp, rank_tp)
                lin.bias = param(_slice(lin.bias, 0, tp, rank_tp))
            if fsdp_group is not None and w.shape[1] % fsdp == 0:
                w = _slice(w, 1, fsdp, rank_fsdp)
                fsdp_names.add(f"{path}.weight")
            lin.weight = param(w)
        if tp_group is not None:
            for path in _NORMS:
                norm = sub(blk, path)
                norm.weight = param(_slice(norm.weight, 0, tp, rank_tp))
    unshard = None
    if fsdp_names:
        def unshard(blk):
            return {n: fsdp_group.all_gather(p, 1) if n in fsdp_names else p
                    for n, p in blk.named_parameters()}
    return LayerSharding(tp, tp_group, unshard)


# ---------------------------------------------------------------------------
# Sharded training: FSDP over fsdp, replicated over dp
# ---------------------------------------------------------------------------

def shard_for_training(model, mesh):
    """FSDP2 (`fully_shard`) of a WanDiT over a (dp, fsdp) DeviceMesh, in
    place: each block an FSDP unit, the root holding the embeddings and
    the head; replicated over dp and sharded over fsdp (HSDP).  The
    parameters become DTensors; the layer functions run through
    `Block.forward` / `WanDiT.forward`, whose hooks gather a unit's
    parameters before it runs and reduce-scatter its gradients (their
    mean over the mesh's ranks) after its backward.  Returns the model."""
    try:
        from torch.distributed.fsdp import fully_shard
    except ImportError:           # torch releases before 2.6
        from torch.distributed._composable.fsdp import fully_shard
    for blk in model.blocks:
        fully_shard(blk, mesh=mesh)
    fully_shard(model, mesh=mesh)
    return model
