"""Device memory on `torch.cuda`: host offload and introspection.

Port of `mmpl_tpu/utils/memory.py`, the analogue of the reference's GPU
memory manager (`demo_utils/memory.py`) and of FSDP's `cpu_offload`
(`utils/distributed.py:23-68`):

  * `offload_params` / `restore_params` move a module's tensors, or a dict
    of them, to pinned host memory and back, bit for bit; a DTensor keeps
    its mesh and placements (the JAX function's `shardings`);
  * `stream_to_host` / `stream_to_device` copy a list of tensors on the
    device's copy stream (JAX's in-jit moves of the same names);
  * `HostStreamer` runs an in-place update over host-resident tensors one
    item at a time through a small ring of device buffers: the copies to
    the card on one copy stream, the update on the compute stream, the
    copies back on another, ordered by CUDA events and never by a host
    wait (the role of JAX's per-leaf programs and their `sync_every`);
  * `HostAdamW` is `torch.optim.AdamW` with its moments in pinned host
    memory, streamed a parameter at a time (JAX's `host_adamw_init` /
    `host_adamw_update`, ZeRO-Offload's placement);
  * `HostBoundaries` keeps what is saved under it, each rematerialised
    block's input (`models/dit.remat(offload=...)`), as a pinned host copy
    and fetches it back one block ahead of its recomputation (JAX's
    `remat_layer(offload=True)`).

On the CPU, where the tests run, every placement is a no-op, as the JAX
package's is there; the streaming loops run all the same.  On a CUDA
device nothing falls back: a host buffer that cannot be pinned raises.

`hbm_bytes_in_use` and `free_hbm_gb` (the reference's
`get_cuda_free_memory_gb`, `demo_utils/memory.py:72-83`) return None on
the CPU, as the JAX package returns None where the backend keeps no
memory statistics.  Not ported: `host_opt_state`, the JAX package's
whole-tree placement of an optimizer state for one jitted step (JAX
structure; `HostAdamW` is the per-parameter update it led to).
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

#: the AdamW state entries `HostAdamW` keeps in host memory
MOMENTS = ("exp_avg", "exp_avg_sq")
#: `HostStreamer`'s device buffers per tensor of an item: one item loading,
#: one updating, one copying back
RING_SLOTS = 3


def _cuda(device) -> Optional[torch.device]:
    """`device` as a CUDA device (the current one for None), or None when
    it is not one or there is no card."""
    if not torch.cuda.is_available():
        return None
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return None
    return torch.device("cuda", torch.cuda.current_device()
                        if dev.index is None else dev.index)


def hbm_bytes_in_use(device=None) -> Optional[int]:
    """Bytes of tensors live on the card (`torch.cuda.memory_allocated`);
    None on the CPU."""
    dev = _cuda(device)
    return None if dev is None else torch.cuda.memory_allocated(dev)


def free_hbm_gb(device=None) -> Optional[float]:
    """GiB a new allocation could take on the card: the free memory
    `torch.cuda.mem_get_info` reports plus what torch's caching allocator
    reserves and no tensor uses; None on the CPU."""
    dev = _cuda(device)
    if dev is None:
        return None
    free, _ = torch.cuda.mem_get_info(dev)
    stats = torch.cuda.memory_stats(dev)
    idle = (stats.get("reserved_bytes.all.current", 0)
            - stats.get("active_bytes.all.current", 0))
    return (free + idle) / 2**30


def supports_host_compute_offload(device=None) -> bool:
    """True where tensors of `device` (default: the current CUDA device,
    if any) are parked in pinned host memory and streamed back: a CUDA
    device.  On the CPU the placement is a no-op."""
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


# ---------------------------------------------------------------------------
# Host tensors
# ---------------------------------------------------------------------------

def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; any other tensor itself."""
    return t._local_tensor if _is_dtensor(t) else t


def _like(p: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """`local` placed as `p` is: a DTensor of p's mesh and placements when
    p is one.  The constructor takes a local tensor on any device, as
    FSDP2's own CPU offload builds its sharded parameters (`from_local`
    would move it to the mesh's device)."""
    if not _is_dtensor(p):
        return local
    from torch.distributed.tensor import DTensor
    return DTensor(local, p._spec, requires_grad=False)


def host_empty_like(t: torch.Tensor, dtype=None) -> torch.Tensor:
    """An empty host tensor shaped as `t`'s local shard: pinned where `t`
    lies on a CUDA device (it raises if the memory cannot be pinned), a
    plain CPU tensor otherwise."""
    loc = _local(t)
    pin = loc.device.type == "cuda"
    out = torch.empty(loc.shape, dtype=dtype or loc.dtype, pin_memory=pin)
    if pin and not out.is_pinned():
        raise RuntimeError(f"host buffer of {out.nbytes} bytes is not "
                           f"pinned")
    return out


def _unregister(ptr: int) -> None:
    torch.cuda.synchronize()        # no copy may still use the pages
    torch.cuda.cudart().cudaHostUnregister(ptr)


def pin_in_place(t: torch.Tensor) -> torch.Tensor:
    """Lock the pages of the fresh contiguous host tensor `t` for the card
    (`cudaHostRegister`, undone when `t` goes), so that copies to and from
    it run asynchronously; raises if the driver refuses.  Unlike
    `pin_memory=True`, whose allocator rounds every buffer up to a power
    of two (16 GB for a 1.3B model's 11.4 GB of moments), it pins exactly
    `t`'s bytes."""
    if t.nbytes:
        err = int(torch.cuda.cudart().cudaHostRegister(t.data_ptr(),
                                                       t.nbytes, 0))
        if err:
            raise RuntimeError(f"cudaHostRegister of {t.nbytes} bytes "
                               f"failed: cudaError {err}")
        weakref.finalize(t, _unregister, t.data_ptr()).atexit = False
    return t


def host_flat_like(tensors: Sequence[torch.Tensor], dtype=None
                   ) -> List[torch.Tensor]:
    """Zeroed host tensors shaped as each of `tensors`' local shards, views
    of one buffer per dtype, pinned (`pin_in_place`) where the tensors lie
    on a CUDA device: one exact-sized pinned buffer in place of one each.
    The zeros are written before the pages are locked, by torch's threads,
    which fault the fresh pages in at once.  `dtype` overrides the
    tensors' own."""
    locs = [_local(t) for t in tensors]
    out: List[Optional[torch.Tensor]] = [None] * len(locs)
    kinds = {}
    for i, loc in enumerate(locs):
        kinds.setdefault(dtype or loc.dtype, []).append(i)
    for kind, idx in kinds.items():
        flat = torch.zeros(sum(locs[i].numel() for i in idx), dtype=kind)
        if locs[idx[0]].device.type == "cuda":
            pin_in_place(flat)
        off = 0
        for i in idx:
            n = locs[i].numel()
            out[i] = flat[off:off + n].view(locs[i].shape)
            off += n
    return out


def _event(stream) -> torch.cuda.Event:
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def stream_to_host(tensors: Sequence[torch.Tensor], dtype=None,
                   flat: bool = True) -> List[torch.Tensor]:
    """Host copies of `tensors` (cast to `dtype` where given), those of
    CUDA tensors pinned: views of one buffer (`host_flat_like`), or with
    `flat=False` each in a buffer of torch's pinned allocator, which a
    tensor's storage alone keeps (a parameter's `.data` keeps no view's
    base).  Each copy is issued on the device's copy stream after what the
    compute stream has queued, and the call returns once they are done.  A
    DTensor's local shard is copied and keeps its placements.  A CPU
    tensor is copied as it is."""
    on_card = [t for t in tensors if _local(t).device.type == "cuda"]
    hosts = iter(host_flat_like(on_card, dtype) if flat and on_card else
                 [host_empty_like(t, dtype) for t in on_card])
    out, streams = [], {}
    for t in tensors:
        loc = _local(t)
        if loc.device.type != "cuda":
            out.append(t.to(dtype or t.dtype, copy=True))
            continue
        src = loc if dtype in (None, loc.dtype) else loc.to(dtype)
        host = next(hosts)
        stream = streams.get(loc.device)
        if stream is None:
            stream = streams[loc.device] = torch.cuda.Stream(loc.device)
            stream.wait_stream(torch.cuda.current_stream(loc.device))
        with torch.cuda.stream(stream):
            host.copy_(src, non_blocking=True)
        src.record_stream(stream)
        out.append(_like(t, host))
    for stream in streams.values():
        stream.synchronize()
    return out


def stream_to_device(tensors: Sequence[torch.Tensor], device=None
                     ) -> List[torch.Tensor]:
    """Device copies of host `tensors` on `device` (default: the current
    CUDA device, a DTensor's mesh device), issued on a copy stream that the
    compute stream then waits for (no host wait).  Tensors already on the
    device, and every tensor when there is no card, are returned as they
    are."""
    out, streams = [], {}
    for t in tensors:
        loc = _local(t)
        dev = _cuda(device if device is not None or not _is_dtensor(t)
                    else t.device_mesh.device_type)
        if dev is None or loc.device == dev:
            out.append(t)
            continue
        stream = streams.get(dev)
        if stream is None:
            stream = streams[dev] = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            moved = loc.to(dev, non_blocking=True)
        moved.record_stream(torch.cuda.current_stream(dev))
        out.append(_like(t, moved))
    for dev, stream in streams.items():
        torch.cuda.current_stream(dev).wait_stream(stream)
    return out


def _module_tensors(module: nn.Module):
    """(owner, name, kind, tensor) of every parameter and buffer."""
    for m in module.modules():
        for kind in ("_parameters", "_buffers"):
            for name, t in getattr(m, kind).items():
                if t is not None:
                    yield m, name, kind, t


def _move_module(module: nn.Module, move) -> nn.Module:
    entries = list(_module_tensors(module))
    if any(_is_dtensor(t) for *_, t in entries):
        raise ValueError("an FSDP2 module's parameters belong to FSDP: "
                         "offload a dict of its tensors instead")
    moved = move([t.detach() for *_, t in entries])
    with torch.no_grad():
        for (m, name, kind, t), new in zip(entries, moved):
            if kind == "_parameters":
                t.data = new
            else:
                m._buffers[name] = new
    return module


def offload_params(params):
    """Move every tensor of `params` off the card into pinned host memory,
    bit for bit.  `params`: a module, whose parameters and buffers move in
    place (returned), or a dict of tensors (a new dict is returned; a
    DTensor keeps its mesh and placements, its local shard moves).  On the
    CPU the tensors are copied where they are."""
    if isinstance(params, nn.Module):
        return _move_module(params,
                            lambda ts: stream_to_host(ts, flat=False))
    return dict(zip(params, stream_to_host(list(params.values()))))


def restore_params(params, device=None):
    """The inverse of `offload_params`: host tensors back on `device`
    (default: the current CUDA device; a DTensor's mesh device, with its
    placements), a module in place, a dict as a new dict."""
    move = lambda ts: stream_to_device(ts, device)
    if isinstance(params, nn.Module):
        return _move_module(params, move)
    return dict(zip(params, move(list(params.values()))))


# ---------------------------------------------------------------------------
# Streaming updates of host-resident state
# ---------------------------------------------------------------------------

class HostStreamer:
    """Runs an in-place update over host-resident tensors on the card, one
    item at a time, through a ring of `RING_SLOTS` device buffers per
    tensor of an item.  Item i's tensors are copied in on a copy stream
    `RING_SLOTS - 1` items ahead, updated on the compute stream once their
    event fires, and copied back on a second copy stream (so both
    directions of the bus run at once); a slot is loaded again only after
    its last copy back has finished.  Only the ring ever holds the state on the card, and the
    host never waits: everything is ordered by CUDA events.  The compute
    stream waits for the last copy back before it goes on; a host reader
    of the tensors calls `synchronize` first.  On the CPU the update runs
    on the host tensors themselves, in the same order."""

    def __init__(self):
        self._device = None
        self._buffers: List[List[torch.Tensor]] = []
        self._h2d = self._d2h = None

    def _ring(self, device: torch.device, nbytes: Sequence[int]):
        """The ring's buffers on `device`, at least `nbytes[j]` bytes for
        the j-th tensor of an item (made or grown on the compute stream,
        which the copy streams wait for)."""
        if self._device != device:
            self._device, self._buffers = device, []
            self._h2d = torch.cuda.Stream(device)
            self._d2h = torch.cuda.Stream(device)
        have = [b.numel() for b in self._buffers[0]] if self._buffers else []
        need = [max(n, have[j]) if j < len(have) else n
                for j, n in enumerate(nbytes)]
        if need != have:
            self._buffers = [[torch.empty(n, dtype=torch.uint8,
                                          device=device) for n in need]
                             for _ in range(RING_SLOTS)]
        return self._buffers

    @property
    def bytes_on_device(self) -> int:
        """Bytes of the ring's device buffers."""
        return sum(b.numel() for slot in self._buffers for b in slot)

    def synchronize(self) -> None:
        """Wait on the host until every copy back has landed."""
        if self._d2h is not None:
            self._d2h.synchronize()

    def run(self, items: Sequence[Sequence[torch.Tensor]],
            update: Callable[[int, List[torch.Tensor]], None],
            device: torch.device) -> None:
        """update(i, tensors) for each item i: `tensors` are item i's host
        tensors as device copies (on the CPU: the host tensors), updated
        in place on the compute stream; the results land back in the host
        tensors."""
        if not items:
            return
        if device.type != "cuda":
            for i, item in enumerate(items):
                update(i, list(item))
            return
        width = len(items[0])
        ring = self._ring(device, [max(item[j].nbytes for item in items)
                                   for j in range(width)])
        comp = torch.cuda.current_stream(device)
        h2d, d2h = self._h2d, self._d2h
        # the ring's and the host tensors' last users: the compute stream
        # and the last run's copies back
        h2d.wait_stream(comp)
        h2d.wait_stream(d2h)
        n, K = len(items), RING_SLOTS
        loaded: List[Optional[torch.cuda.Event]] = [None] * n
        stored: List[Optional[torch.cuda.Event]] = [None] * n
        views: List[Optional[List[torch.Tensor]]] = [None] * n

        def load(i):
            with torch.cuda.stream(h2d):
                if i >= K:      # the slot's previous item is back home
                    h2d.wait_event(stored[i - K])
                views[i] = [buf[:h.nbytes].view(h.dtype).view(h.shape)
                            .copy_(h, non_blocking=True)
                            for buf, h in zip(ring[i % K], items[i])]
                loaded[i] = _event(h2d)

        for i in range(min(K - 1, n)):
            load(i)
        for i in range(n):
            if i + K - 1 < n:
                load(i + K - 1)
            comp.wait_event(loaded[i])
            update(i, views[i])
            updated = _event(comp)
            with torch.cuda.stream(d2h):
                d2h.wait_event(updated)
                for h, v in zip(items[i], views[i]):
                    h.copy_(v, non_blocking=True)
                stored[i] = _event(d2h)
            views[i] = None
        comp.wait_stream(d2h)


def _scalar_dtype() -> torch.dtype:
    """The dtype of AdamW's `step` (torch.optim's `_get_scalar_dtype`)."""
    return torch.float64 if torch.get_default_dtype() == torch.float64 \
        else torch.float32


class HostAdamW(torch.optim.AdamW):
    """`torch.optim.AdamW` whose `exp_avg` and `exp_avg_sq` live in pinned
    host memory (ZeRO-Offload's placement; JAX's `host_adamw_init` /
    `host_adamw_update`).

    The moments are made on the host and never pass through the card
    whole: each step streams one parameter's moments at a time through a
    `HostStreamer` and runs AdamW's own update on them, one single-
    parameter group at a time, so that it computes what the resident
    optimizer computes, bit for bit (the same kernels: torch picks the
    same implementation for one tensor of a kind as for many).  Its
    `state_dict` has AdamW's format, `step` included, so a run switches
    between the two across a resume; `load_state_dict` puts the moments
    in host memory without staging them on the card.  A DTensor parameter
    (FSDP2) keeps the moments of its local shard, as DTensors of its
    placements.  On the CPU the moments are plain CPU tensors."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 1e-2):
        super().__init__(params, lr=lr, betas=betas, eps=eps,
                         weight_decay=weight_decay)
        self.streamer = HostStreamer()

    def _make_state(self, params: Sequence[torch.Tensor]) -> None:
        """The state of those of `params` that have none: `step`, and the
        moments zeroed in host memory, each moment of all of them in one
        buffer (`host_flat_like`)."""
        new = [p for p in params if not self.state[p]]
        if not new:
            return
        for p in new:
            self.state[p]["step"] = torch.tensor(0.0, dtype=_scalar_dtype())
        for k in MOMENTS:
            for p, h in zip(new, host_flat_like(new)):
                self.state[p][k] = _like(p, h)

    @property
    def host_bytes(self) -> int:
        """Bytes of the moments in host memory."""
        return sum(_local(st[k]).nbytes for st in self.state.values()
                   for k in MOMENTS if k in st)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        todo = [(g, p) for g in self.param_groups for p in g["params"]
                if p.grad is not None]
        if not todo:
            return loss
        self._make_state([p for _, p in todo])
        states = [self.state[p] for _, p in todo]
        groups = self.param_groups

        def update(i, moments):
            group, p = todo[i]
            st = states[i]
            home = [st[k] for k in MOMENTS]
            for k, m in zip(MOMENTS, moments):
                st[k] = _like(p, m)
            self.param_groups = [dict(group, params=[p])]
            try:
                torch.optim.AdamW.step(self)
            finally:
                self.param_groups = groups
                for k, h in zip(MOMENTS, home):
                    st[k] = h

        self.streamer.run([[_local(st[k]) for k in MOMENTS]
                           for st in states], update,
                          _local(todo[0][1]).device)
        return loss

    def state_dict(self):
        self.streamer.synchronize()
        return super().state_dict()

    def load_state_dict(self, state_dict) -> None:
        """AdamW's load, with each moment copied into (or, where it is
        already a host tensor of the parameter's local shape and dtype,
        kept in) host memory instead of moved to the parameter's device."""
        self.streamer.synchronize()
        saved = state_dict["state"]
        light = dict(state_dict, state={
            i: {k: torch.empty(0) if k in MOMENTS else v
                for k, v in st.items()} for i, st in saved.items()})
        super().load_state_dict(light)
        ids = [i for g in state_dict["param_groups"] for i in g["params"]]
        params = [p for g in self.param_groups for p in g["params"]]
        by_id = dict(zip(ids, params))
        copy = []
        for i, st in saved.items():
            p = by_id[i]
            for k in MOMENTS:
                if k not in st:
                    continue
                if _at_home(p, st[k]):
                    self.state[p][k] = _like(p, _local(st[k]))
                else:
                    copy.append((p, k, _local(st[k])))
        hosts = host_flat_like([p for p, _, _ in copy]) if copy else []
        for (p, k, src), host in zip(copy, hosts):
            host.copy_(src)
            self.state[p][k] = _like(p, host)


def _at_home(p: torch.Tensor, value: torch.Tensor) -> bool:
    """Whether `value` (a tensor or DTensor shaped as p's local shard)
    already is a host tensor of p's dtype, pinned for a parameter on the
    card (a sharded restore loads into the state in place)."""
    src, loc = _local(value), _local(p)
    return (src.device.type == "cpu" and src.dtype == loc.dtype
            and src.shape == loc.shape
            and (loc.device.type != "cuda" or src.is_pinned()))


# ---------------------------------------------------------------------------
# Block boundaries in host memory
# ---------------------------------------------------------------------------

class _Boundary:
    """One saved tensor: its host copy (on the CPU, the tensor itself),
    the event that ends the copy, and, once fetched back, the device copy
    and the event that ends that."""
    __slots__ = ("host", "device", "stored", "fetched", "index",
                 "__weakref__")


class HostBoundaries(torch.autograd.graph.saved_tensors_hooks):
    """Saved-tensor hooks that keep every tensor saved under them in
    pinned host memory: one object per forward, entered around each
    block's `torch.utils.checkpoint` call (`models/dit.remat`), under
    which the only tensor autograd saves is the block's input.

    Pack: a pinned host copy on a copy stream, after what the compute
    stream has queued; the device tensor is released to the allocator once
    the copy has run (`record_stream`).  Unpack, in the backward pass at
    the block's recomputation: the copy back to the card (fetched ahead
    where it could be) is waited for by the compute stream, and the copy
    back of the block saved before it starts on another copy stream, so
    it runs beside this block's recomputation and backward.  Values are
    unchanged.  On the CPU the tensors stay where they are and the same
    steps run."""

    def __init__(self):
        self._saved: List[weakref.ref] = []
        self._streams: Dict[torch.device, tuple] = {}
        super().__init__(self._pack, self._unpack)

    def _streams_of(self, device):
        if device not in self._streams:
            self._streams[device] = (torch.cuda.Stream(device),
                                     torch.cuda.Stream(device))
        return self._streams[device]

    def _pack(self, t: torch.Tensor) -> _Boundary:
        b = _Boundary()
        b.device, b.fetched, b.stored = t.device, None, None
        b.index = None
        if t.device.type == "cuda":
            _, d2h = self._streams_of(t.device)
            b.host = host_empty_like(t)
            d2h.wait_stream(torch.cuda.current_stream(t.device))
            with torch.cuda.stream(d2h):
                b.host.copy_(t, non_blocking=True)
            t.record_stream(d2h)
            b.stored = _event(d2h)
        else:
            b.host = t
        if t.numel():   # not checkpoint's empty marker
            b.index = len(self._saved)
            self._saved.append(weakref.ref(b))
        return b

    def _fetch(self, b: _Boundary):
        if b.fetched is None:
            if b.stored is None:
                b.fetched = (b.host, None)
            else:
                h2d, _ = self._streams_of(b.device)
                h2d.wait_event(b.stored)
                with torch.cuda.stream(h2d):
                    dev = b.host.to(b.device, non_blocking=True)
                b.fetched = (dev, _event(h2d))
        return b.fetched

    def _unpack(self, b: _Boundary) -> torch.Tensor:
        t, ready = self._fetch(b)
        b.fetched = None      # a second backward fetches again
        if ready is not None:
            comp = torch.cuda.current_stream(b.device)
            comp.wait_event(ready)
            t.record_stream(comp)
        if b.index:
            before = self._saved[b.index - 1]()
            if before is not None:
                self._fetch(before)
        return t
