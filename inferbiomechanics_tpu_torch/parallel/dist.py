"""Data parallelism over processes: one rank a device, ``torch.distributed``.

PyTorch counterpart of the collectives of ``inferbiomechanics_tpu/parallel/
mesh.py``'s meshes spread over processes: one rank stands for one JAX
device (``parallel/mesh.py`` lays the ranks out on the JAX meshes' axes).
The JAX package gets its collectives from XLA (the gradient ``psum`` GSPMD
inserts, the explicit one of ``train/step.py::lowp_allreduce_grads``); here
they are explicit, and each takes the :class:`Group` of ranks it reduces
over (one axis of a layout; None, the default, is the whole world):

- :class:`GradAllReduce`: the gradients left on the parameters after the
  backward (and after ``--grad-accum-steps``' accumulation), mean-reduced
  over the ranks in ONE collective a step, together with the step's
  metrics; with ``--grad-allreduce-dtype bf16`` the gradients are cast to
  bf16, summed in bf16, cast back and divided by the world size, the JAX
  package's order (a sum in bf16, not torch's ``bf16_compress_hook``, which
  divides before it sums), and the metrics are averaged in float32 beside;
- :func:`sum_over_ranks`: a differentiable sum over the ranks (its backward
  sums the cotangents), for the batch statistics of a BatchNorm
  (``models/norm.py``) and the Augmenter's noise scale, which the JAX
  package computes over the global batch;
- :func:`mean_over_ranks` for evaluation metrics, :func:`all_gather` for
  a tensor's slices (``parallel/sharding_rules.py::gather_state``);
- point to point, for the pipeline's activations and their gradients
  (``parallel/pipeline.py``): :func:`send` and :func:`recv` (NCCL: device
  to device; gloo, whose send and receive take host memory only: through
  a host copy on each side, the compute staying on the device), and
  :func:`broadcast_from` for one rank's tensor to the others of a group;
  :data:`p2p_stats` counts their calls, bytes and host seconds;
- world-wide, on the host group: :func:`any_rank` for a flag that must
  stop every rank at the same step boundary (SIGTERM), :func:`barrier`,
  :func:`gather_host` (host arrays from every rank) and
  :func:`move_host_tensors` (tensors from one rank to another).

A group of one rank makes no collective: its sum is the identity.

The backend is an explicit argument: NCCL for CUDA devices (one GPU a
rank), gloo for the CPU, or gloo for ranks that share a GPU. NCCL
collectives can be captured in a CUDA graph (``train/step.py::GraphedStep``
runs its first steps eagerly, so the communicator exists before the
capture); gloo ones cannot, so a step that holds a gloo collective runs
eagerly (:func:`can_capture`). Host-side flags always travel over a gloo
group of CPU tensors, so reading them never waits for the device.

Without a process group every function here is the identity of one rank:
rank 0 of 1, :func:`is_main` True, no collective.

:func:`start_from_env` is the ``IB_MULTIHOST`` start-up of the ``train``
and ``sweep`` commands, from torchrun's environment
(:func:`process_group_from_env`); :func:`spawn` runs a function on n ranks
of this machine (the tests, and ``chip_smoke.py``'s multi-rank runs).
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
import socket
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as tdist

logger = logging.getLogger(__name__)

BACKENDS = ('nccl', 'gloo')
DEFAULT_TIMEOUT_S = 600.0

_host_group = None      # gloo group for host-side flags (None: the default group)
_subgroups: Dict[Tuple[int, ...], object] = {}     # ranks -> process group
_timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)


@dataclass(frozen=True)
class Group:
    """The ranks a collective reduces over, in their axis's order (a strict
    part of the world; the whole world is ``None``), and their process group
    (None for a group of one rank, which makes no collective)."""
    ranks: Tuple[int, ...]
    handle: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)


# -- the process group ---------------------------------------------------------


def is_initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def rank() -> int:
    return tdist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return tdist.get_world_size() if is_initialized() else 1


def group_size(group: Optional[Group] = None) -> int:
    """The ranks in ``group`` (None: the world)."""
    return world_size() if group is None else group.size


def group_rank(group: Optional[Group] = None) -> int:
    """This rank's place in ``group`` (None: the world)."""
    return rank() if group is None else group.ranks.index(rank())


def _handle(group: Optional[Group]):
    return None if group is None else group.handle


def subgroup(ranks: Sequence[int]) -> Optional[Group]:
    """The :class:`Group` of ``ranks``: None when they are the whole world,
    no process group for one rank, else a process group over them (made
    once and kept until :func:`shutdown`). Every rank must call this for
    every group of two or more ranks, in one order, members or not: a rank
    that skips one hangs the others."""
    ranks = tuple(int(r) for r in ranks)
    if len(ranks) == world_size():
        return None
    if len(ranks) == 1:
        return Group(ranks)
    if ranks not in _subgroups:
        _subgroups[ranks] = tdist.new_group(list(ranks), timeout=_timeout)
    return Group(ranks, _subgroups[ranks])


def is_main() -> bool:
    """True on the rank that writes checkpoints, the sidecar and logs."""
    return rank() == 0


def backend() -> Optional[str]:
    return tdist.get_backend() if is_initialized() else None


def can_capture(group: Optional[Group] = None) -> bool:
    """True when a train step's collectives over ``group`` can be captured
    in a CUDA graph: no process group or a group of one rank (no
    collective), or NCCL."""
    return (not is_initialized() or backend() == 'nccl'
            or (group is not None and group.size == 1))


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return 'nccl' if torch.device(device).type == 'cuda' else 'gloo'


def init(backend_name: str, rank_: int, world: int, init_method: str, device=None,
         timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join a process group of ``world`` ranks as ``rank_`` over
    ``backend_name`` (``nccl`` or ``gloo``), rendezvous at ``init_method``
    (``env://``, ``tcp://host:port`` or ``file://path``). ``device`` is this
    rank's device; a CUDA device becomes the current one, and NCCL binds its
    communicator to it. Collectives that wait longer than ``timeout_s``
    fail instead of hanging."""
    global _host_group, _timeout
    if backend_name not in BACKENDS:
        raise ValueError(f'backend must be one of {BACKENDS}, got {backend_name!r}')
    device = torch.device(device if device is not None else 'cpu')
    if backend_name == 'nccl' and device.type != 'cuda':
        raise ValueError(f'NCCL needs a CUDA device, got {device}')
    if device.type == 'cuda':
        if device.index is None:
            device = torch.device('cuda', torch.cuda.current_device())
        torch.cuda.set_device(device)
    kw = dict(backend=backend_name, init_method=init_method, rank=rank_, world_size=world,
              timeout=datetime.timedelta(seconds=timeout_s))
    tdist.init_process_group(**kw)
    _timeout = kw['timeout']
    _host_group = (tdist.new_group(backend='gloo', timeout=kw['timeout'])
                   if backend_name == 'nccl' else None)
    logger.info('process group: rank %d of %d, backend %s, device %s', rank_, world,
                backend_name, device)


def shutdown() -> None:
    """Leave the process group (after every rank's last collective)."""
    global _host_group
    if is_initialized():
        tdist.destroy_process_group()
    _host_group = None
    _subgroups.clear()


def start_from_env(device: str = 'cuda', environ=None) -> torch.device:
    """The ``IB_MULTIHOST`` start-up (the JAX command's
    ``jax.distributed.initialize()``): a process group from torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``). The backend is
    ``IB_MULTIHOST``'s value when it names one (``nccl`` or ``gloo``), else
    NCCL for ``--device cuda`` and gloo for ``--device cpu``. On CUDA the
    rank's device is ``cuda:LOCAL_RANK`` (modulo the GPUs present, for gloo
    ranks that share one); NCCL refuses more ranks than GPUs. Returns the
    rank's device."""
    env = os.environ if environ is None else environ
    asked = env.get('IB_MULTIHOST', '').strip().lower()
    kind = torch.device(device).type
    name = asked if asked in BACKENDS else default_backend(device)
    rank_, world = int(env['RANK']), int(env['WORLD_SIZE'])
    local = int(env.get('LOCAL_RANK', rank_))
    local_world = int(env.get('LOCAL_WORLD_SIZE', world))
    dev = torch.device(device)
    if kind == 'cuda':
        n_gpus = torch.cuda.device_count()
        if n_gpus == 0:
            raise RuntimeError('--device cuda: torch.cuda.is_available() is False')
        if name == 'nccl' and local_world > n_gpus:
            raise ValueError(f'NCCL takes one GPU a rank: {local_world} ranks on this node, '
                             f'{n_gpus} GPU(s); IB_MULTIHOST=gloo lets ranks share a GPU')
        dev = torch.device('cuda', local % n_gpus)
    init(name, rank_, world, 'env://', dev)
    if rank_ == 0:
        print(f'process group: {world} ranks, backend {name}, rank 0 on {dev}', flush=True)
    return dev


@contextlib.contextmanager
def process_group_from_env(device: str):
    """The commands' ``IB_MULTIHOST`` start-up: with ``IB_MULTIHOST`` set
    and no process group yet, :func:`start_from_env` on entry and
    :func:`shutdown` on exit; yields the rank's device (``device`` itself
    otherwise)."""
    started = bool(os.environ.get('IB_MULTIHOST')) and not is_initialized()
    if started:
        device = start_from_env(device)
    try:
        yield device
    finally:
        if started:
            shutdown()


def free_port() -> int:
    """A TCP port on localhost that is free now (any free port)."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return int(s.getsockname()[1])


def spawn(fn: Callable, world: int, *args, backend_name: str = 'gloo', device='cpu',
          init_file: Optional[str] = None, timeout_s: float = 120.0) -> List:
    """Run ``fn(*args)`` on ``world`` ranks of this machine, one process
    each (the ``spawn`` start method, one torch thread a process), in a
    process group over ``backend_name`` that rendezvous at ``init_file``
    (``file://``; a free TCP port when None); ``device`` is each rank's
    device (``cuda`` ranks share ``cuda:0`` unless there are enough GPUs).
    ``fn`` must be importable (a module-level function). Returns the ranks'
    results in rank order; raises if a rank raised or did not finish within
    ``timeout_s``, after ending every process."""
    import multiprocessing as mp
    method = f'file://{init_file}' if init_file else f'tcp://127.0.0.1:{free_port()}'
    ctx = mp.get_context('spawn')
    out = ctx.Queue()
    procs = [ctx.Process(target=_spawned, daemon=True,
                         args=(fn, r, world, backend_name, method, str(device), timeout_s,
                               args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results: Dict[int, object] = {}
    errors: List[str] = []
    import queue
    try:
        for _ in range(world):
            try:
                r, ok, value = out.get(timeout=timeout_s)
            except queue.Empty:
                errors.append(f'a rank did not finish within {timeout_s:.0f} s')
                break
            if ok:
                results[r] = value
            else:
                errors.append(f'rank {r}: {value}')
                break
    finally:
        for p in procs:
            p.join(timeout=5.0 if not errors else 0.5)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError('; '.join(errors))
    return [results[r] for r in range(world)]


def _spawned(fn, rank_, world, backend_name, method, device, timeout_s, args, out) -> None:
    import traceback
    torch.set_num_threads(1)
    try:
        dev = torch.device(device)
        if dev.type == 'cuda':
            dev = torch.device('cuda', rank_ % torch.cuda.device_count())
        init(backend_name, rank_, world, method, dev, timeout_s=timeout_s)
        try:
            out.put((rank_, True, fn(*args)))
        finally:
            shutdown()
    except BaseException:           # the parent reports it and ends the other ranks
        out.put((rank_, False, traceback.format_exc()))


# -- collectives ---------------------------------------------------------------


def barrier() -> None:
    if is_initialized() and world_size() > 1:
        tdist.barrier(group=_host_group)


def any_rank(flag: bool) -> bool:
    """True on every rank when ``flag`` is True on any (a CPU collective on
    the host group: it never waits for the device). Every rank must call it
    at the same point."""
    if not is_initialized() or world_size() == 1:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    tdist.all_reduce(t, op=tdist.ReduceOp.MAX, group=_host_group)
    return bool(t.item())


def gather_host(x: np.ndarray) -> np.ndarray:
    """Every rank's float64 array ``x`` (one shape on every rank), stacked
    in rank order: [world, ...], on the host group. Every rank must call it
    at the same point."""
    x = np.asarray(x, np.float64)
    if not is_initialized() or world_size() == 1:
        return x[None]
    t = torch.from_numpy(np.ascontiguousarray(x))
    out = [torch.empty_like(t) for _ in range(world_size())]
    tdist.all_gather(out, t, group=_host_group)
    return np.stack([o.numpy() for o in out])


def all_gather(x: torch.Tensor, group: Optional[Group] = None) -> List[torch.Tensor]:
    """``x`` (one shape on every rank) from every rank of ``group`` (None:
    the world), in the group's order, on ``x``'s device; over gloo the
    tensors travel through host memory."""
    if not is_initialized() or group_size(group) == 1:
        return [x]
    t = x.detach().contiguous()
    if backend() == 'gloo':
        t = t.cpu()
    out = [torch.empty_like(t) for _ in range(group_size(group))]
    tdist.all_gather(out, t, group=_handle(group))
    return [o.to(x.device) for o in out]


def _as_bytes(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.detach().contiguous().view(-1).view(torch.uint8).cpu()
                      for t in tensors])


def move_host_tensors(tensors: Sequence[torch.Tensor], src: int, dst: int) -> None:
    """Copy ``tensors`` from rank ``src`` into the same-shaped ``tensors``
    of rank ``dst``, in place and bit for bit (their bytes over the host
    group, whatever the device). Only ``src`` and ``dst`` call it, once
    each, and every rank goes through its moves in one order."""
    me = rank()
    if me == src:
        tdist.send(_as_bytes(tensors), dst, group=_host_group)
    elif me == dst:
        buf = torch.empty(sum(t.numel() * t.element_size() for t in tensors),
                          dtype=torch.uint8)
        tdist.recv(buf, src, group=_host_group)
        at = 0
        with torch.no_grad():
            for t in tensors:
                n = t.numel() * t.element_size()
                t.copy_(buf[at:at + n].clone().view(t.dtype).view(t.shape))
                at += n


# point-to-point transfers so far: calls, bytes and host seconds spent in
# them (the host copies of gloo's path included)
p2p_stats = {'calls': 0, 'bytes': 0, 'seconds': 0.0}


def reset_p2p_stats() -> None:
    p2p_stats.update(calls=0, bytes=0, seconds=0.0)


def _count_p2p(t: torch.Tensor, t0: float) -> None:
    p2p_stats['calls'] += 1
    p2p_stats['bytes'] += t.numel() * t.element_size()
    p2p_stats['seconds'] += time.perf_counter() - t0


def send(t: torch.Tensor, dst: int) -> None:
    """Send ``t`` to rank ``dst`` of the world, which takes it with
    :func:`recv` (the same shape and dtype). NCCL sends the device tensor;
    gloo's send takes host memory, so the tensor is copied to the host first
    (which waits for the device)."""
    t0 = time.perf_counter()
    x = t.detach().contiguous()
    if backend() == 'gloo':
        x = x.cpu()
    tdist.send(x, dst)
    _count_p2p(x, t0)


def recv(shape: Sequence[int], dtype: torch.dtype, src: int, device) -> torch.Tensor:
    """The tensor rank ``src`` of the world sends with :func:`send`, on
    ``device`` (gloo: received in host memory, then copied to the device)."""
    t0 = time.perf_counter()
    host = backend() == 'gloo'
    buf = torch.empty(tuple(shape), dtype=dtype, device='cpu' if host else device)
    tdist.recv(buf, src)
    out = buf.to(device) if host else buf
    _count_p2p(buf, t0)
    return out


def broadcast_from(t: torch.Tensor, src: int, group: Optional[Group] = None) -> torch.Tensor:
    """``t`` of rank ``src`` (of the world; a member of ``group``) on every
    rank of ``group`` (None: the world), on ``t``'s device; every member
    passes a tensor of that shape and dtype. gloo: through host memory."""
    if not is_initialized() or group_size(group) == 1:
        return t
    t0 = time.perf_counter()
    x = t.detach().contiguous()
    if backend() == 'gloo':
        x = x.cpu()
    tdist.broadcast(x, src, group=_handle(group))
    _count_p2p(x, t0)
    return x.to(t.device)


class _SumOverRanks(torch.autograd.Function):
    """y = sum over the group's ranks of x; the backward sums the
    cotangents over them (each rank's loss reads y)."""

    @staticmethod
    def forward(ctx, x, handle):
        ctx.handle = handle
        y = x.clone()
        tdist.all_reduce(y, group=handle)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        tdist.all_reduce(g, group=ctx.handle)
        return g, None


def sum_over_ranks(x: torch.Tensor, group: Optional[Group] = None) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks, differentiable (identity
    without a process group, or over one rank)."""
    if not is_initialized() or group_size(group) == 1:
        return x
    return _SumOverRanks.apply(x, _handle(group))


class RankSum:
    """``sum_over_ranks`` over one group as a callable (a BatchNorm's
    ``stats_sync``), with the group's rank count as :attr:`size`."""

    def __init__(self, group: Optional[Group] = None):
        self.group = group
        self.size = group_size(group)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return sum_over_ranks(x, self.group)


def global_std(x: torch.Tensor, dims, group: Optional[Group] = None) -> torch.Tensor:
    """Population standard deviation of ``x`` over ``dims`` and ``group``'s
    ranks (every rank holding as many rows), in ``x``'s dtype: the global
    mean first, then the global mean of squared deviations (``torch.std``
    with ``correction=0``). Not differentiable (it scales data)."""
    if not is_initialized() or group_size(group) == 1:
        return torch.std(x, dim=dims, keepdim=True, correction=0)
    xf = x.float()
    n = group_size(group)
    for d in dims:
        n *= x.shape[d]
    s = xf.sum(dim=dims, keepdim=True)
    tdist.all_reduce(s, group=_handle(group))
    mean = s / n
    d2 = ((xf - mean) ** 2).sum(dim=dims, keepdim=True)
    tdist.all_reduce(d2, group=_handle(group))
    return torch.sqrt(d2 / n).to(x.dtype)


def mean_over_ranks(metrics: Dict[str, torch.Tensor],
                    group: Optional[Group] = None) -> Dict[str, torch.Tensor]:
    """Metrics (tensors, each a mean over the rank's rows; every rank holding
    as many) averaged over ``group``'s ranks in one float32 collective: the
    metrics of the global batch."""
    if not is_initialized() or group_size(group) == 1:
        return metrics
    keys = list(metrics)
    parts = [torch.as_tensor(metrics[k]) for k in keys]
    device = next((p.device for p in parts if p.device.type != 'cpu'), torch.device('cpu'))
    flat = torch.cat([p.reshape(-1).float().to(device) for p in parts])
    tdist.all_reduce(flat, group=_handle(group))
    flat /= group_size(group)
    out, at = {}, 0
    for k, p in zip(keys, parts):
        out[k] = flat[at:at + p.numel()].view(p.shape)
        at += p.numel()
    return out


class GradAllReduce:
    """``sync(metrics) -> metrics`` after a step's backward: the gradients on
    ``params`` and the step's metrics, mean-reduced over ``group``'s ranks
    (None: the world).

    In float32 (``reduce_dtype`` None): one flat buffer of every gradient
    and the metrics, one all-reduce (a sum), divided by the group's size.
    With ``reduce_dtype`` bf16: the gradients cast to bf16 and summed in
    bf16, cast back to their dtype and divided by the group's size (the JAX
    package's ``psum(g.astype(bf16)).astype(g.dtype) / n``), and the metrics
    averaged in a float32 all-reduce of their own. The gradients are written
    back in place. A parameter without a gradient (unused in the step) has
    none on every rank and is left out. Inside a captured step the
    collectives are part of the graph (NCCL)."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 reduce_dtype: Optional[torch.dtype] = None, group: Optional[Group] = None):
        self.params = [p for p in params if p.requires_grad]
        self.reduce_dtype = reduce_dtype
        self.handle = _handle(group)
        self.world = group_size(group)

    def __call__(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        grads = [p.grad for p in self.params if p.grad is not None]
        keys = list(metrics)
        mparts = [metrics[k] for k in keys]
        mflat = torch.cat([m.reshape(-1).float() for m in mparts])
        sizes = [g.numel() for g in grads]
        if self.reduce_dtype is None:
            flat = torch.cat([g.reshape(-1).float() for g in grads] + [mflat])
            tdist.all_reduce(flat, group=self.handle)
            flat.div_(self.world)
            gflat, mflat = flat[:sum(sizes)], flat[sum(sizes):]
        else:
            low = torch.cat([g.reshape(-1).to(self.reduce_dtype) for g in grads])
            tdist.all_reduce(low, group=self.handle)
            gflat = low.float().div_(self.world)
            mflat = mflat.clone()
            tdist.all_reduce(mflat, group=self.handle)
            mflat.div_(self.world)
        for g, part in zip(grads, gflat.split(sizes)):
            g.copy_(part.view_as(g))
        out, at = {}, 0
        for k, m in zip(keys, mparts):
            out[k] = mflat[at:at + m.numel()].view(m.shape).to(m.dtype)
            at += m.numel()
        return out


def draw_shard(group: Optional[Group] = None):
    """(this rank's place in ``group``, its size) when a step's draws are
    those of the global batch over the group, of which the rank keeps its
    rows (``models/common.py::global_rows``); None for one rank. The group
    is the ``data`` axis of the layout (None: the world)."""
    return (group_rank(group), group_size(group)) if group_size(group) > 1 else None


def attach(state, model: torch.nn.Module, reduce_dtype: Optional[torch.dtype] = None,
           augment=None, group: Optional[Group] = None) -> None:
    """Make ``state``'s steps data-parallel over ``group`` (the layout's
    ``data`` axis; None: the world): the gradient all-reduce after every
    backward (:class:`GradAllReduce`), and the BatchNorms' batch statistics
    and the Augmenter's noise scale over the global batch
    (:class:`RankSum`, :func:`global_std`). Without a process group nothing
    changes, nor over a group of one rank of several (no collective); at
    world size 1 only the all-reduce is added (a sum of one, bitwise the
    step without it)."""
    if not is_initialized() or (group is not None and group.size == 1):
        return
    state.grad_sync = GradAllReduce(model.parameters(), reduce_dtype, group)
    if group_size(group) == 1:
        return
    for m in model.modules():
        if hasattr(m, 'stats_sync'):
            m.stats_sync = RankSum(group)
    if augment is not None:
        augment.std_fn = lambda x, dims: global_std(x, dims, group)
