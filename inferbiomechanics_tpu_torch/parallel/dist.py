"""Data parallelism over processes: one rank a device, ``torch.distributed``.

PyTorch counterpart of ``inferbiomechanics_tpu/parallel/mesh.py`` with its
``data`` axis spread over processes: one rank stands for one JAX process
with one device. The JAX package gets its collectives from XLA (the
gradient ``psum`` GSPMD inserts, the explicit one of
``train/step.py::lowp_allreduce_grads``); here they are explicit:

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
- :func:`mean_over_ranks` for evaluation metrics, :func:`any_rank` for a
  flag that must stop every rank at the same step boundary (SIGTERM), and
  :func:`barrier`.

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
command, from torchrun's environment; :func:`spawn` runs a function on n
ranks of this machine (the tests, and ``chip_smoke.py``'s two-rank runs).
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
from typing import Callable, Dict, Iterable, List, Optional

import torch
import torch.distributed as tdist

logger = logging.getLogger(__name__)

BACKENDS = ('nccl', 'gloo')
DEFAULT_TIMEOUT_S = 600.0

_host_group = None      # gloo group for host-side flags (None: the default group)


# -- the process group ---------------------------------------------------------


def is_initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def rank() -> int:
    return tdist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return tdist.get_world_size() if is_initialized() else 1


def is_main() -> bool:
    """True on the rank that writes checkpoints, the sidecar and logs."""
    return rank() == 0


def backend() -> Optional[str]:
    return tdist.get_backend() if is_initialized() else None


def can_capture() -> bool:
    """True when a train step's collectives can be captured in a CUDA graph:
    no process group (no collective) or NCCL."""
    return not is_initialized() or backend() == 'nccl'


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
    global _host_group
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


class _SumOverRanks(torch.autograd.Function):
    """y = sum over the ranks of x; the backward sums the cotangents over
    the ranks (each rank's loss reads y)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        tdist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        tdist.all_reduce(g)
        return g


def sum_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable (identity without a
    process group)."""
    if not is_initialized() or world_size() == 1:
        return x
    return _SumOverRanks.apply(x)


def global_std(x: torch.Tensor, dims) -> torch.Tensor:
    """Population standard deviation of ``x`` over ``dims`` and the ranks
    (every rank holding as many rows), in ``x``'s dtype: the global mean
    first, then the global mean of squared deviations (``torch.std`` with
    ``correction=0``). Not differentiable (it scales data)."""
    if not is_initialized() or world_size() == 1:
        return torch.std(x, dim=dims, keepdim=True, correction=0)
    xf = x.float()
    n = world_size()
    for d in dims:
        n *= x.shape[d]
    s = xf.sum(dim=dims, keepdim=True)
    tdist.all_reduce(s)
    mean = s / n
    d2 = ((xf - mean) ** 2).sum(dim=dims, keepdim=True)
    tdist.all_reduce(d2)
    return torch.sqrt(d2 / n).to(x.dtype)


def mean_over_ranks(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Metrics (tensors, each a mean over the rank's rows; every rank holding
    as many) averaged over the ranks in one float32 collective: the metrics
    of the global batch."""
    if not is_initialized() or world_size() == 1:
        return metrics
    keys = list(metrics)
    parts = [torch.as_tensor(metrics[k]) for k in keys]
    device = next((p.device for p in parts if p.device.type != 'cpu'), torch.device('cpu'))
    flat = torch.cat([p.reshape(-1).float().to(device) for p in parts])
    tdist.all_reduce(flat)
    flat /= world_size()
    out, at = {}, 0
    for k, p in zip(keys, parts):
        out[k] = flat[at:at + p.numel()].view(p.shape)
        at += p.numel()
    return out


class GradAllReduce:
    """``sync(metrics) -> metrics`` after a step's backward: the gradients on
    ``params`` and the step's metrics, mean-reduced over the ranks.

    In float32 (``reduce_dtype`` None): one flat buffer of every gradient
    and the metrics, one all-reduce (a sum), divided by the world size.
    With ``reduce_dtype`` bf16: the gradients cast to bf16 and summed in
    bf16, cast back to their dtype and divided by the world size (the JAX
    package's ``psum(g.astype(bf16)).astype(g.dtype) / n``), and the metrics
    averaged in a float32 all-reduce of their own. The gradients are written
    back in place. A parameter without a gradient (unused in the step) has
    none on every rank and is left out. Inside a captured step the
    collectives are part of the graph (NCCL)."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 reduce_dtype: Optional[torch.dtype] = None):
        self.params = [p for p in params if p.requires_grad]
        self.reduce_dtype = reduce_dtype
        self.world = world_size()

    def __call__(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        grads = [p.grad for p in self.params if p.grad is not None]
        keys = list(metrics)
        mparts = [metrics[k] for k in keys]
        mflat = torch.cat([m.reshape(-1).float() for m in mparts])
        sizes = [g.numel() for g in grads]
        if self.reduce_dtype is None:
            flat = torch.cat([g.reshape(-1).float() for g in grads] + [mflat])
            tdist.all_reduce(flat)
            flat.div_(self.world)
            gflat, mflat = flat[:sum(sizes)], flat[sum(sizes):]
        else:
            low = torch.cat([g.reshape(-1).to(self.reduce_dtype) for g in grads])
            tdist.all_reduce(low)
            gflat = low.float().div_(self.world)
            mflat = mflat.clone()
            tdist.all_reduce(mflat)
            mflat.div_(self.world)
        for g, part in zip(grads, gflat.split(sizes)):
            g.copy_(part.view_as(g))
        out, at = {}, 0
        for k, m in zip(keys, mparts):
            out[k] = mflat[at:at + m.numel()].view(m.shape).to(m.dtype)
            at += m.numel()
        return out


def draw_shard():
    """(rank, world size) when a step's draws are those of the global batch,
    of which the rank keeps its rows (``models/common.py::global_rows``);
    None for one rank."""
    return (rank(), world_size()) if world_size() > 1 else None


def attach(state, model: torch.nn.Module, reduce_dtype: Optional[torch.dtype] = None,
           augment=None) -> None:
    """Make ``state``'s steps data-parallel over the process group: the
    gradient all-reduce after every backward (:class:`GradAllReduce`), and
    the BatchNorms' batch statistics and the Augmenter's noise scale over
    the global batch (:func:`sum_over_ranks`, :func:`global_std`). Without a
    process group nothing changes; at world size 1 only the all-reduce is
    added (a sum of one, bitwise the step without it)."""
    if not is_initialized():
        return
    state.grad_sync = GradAllReduce(model.parameters(), reduce_dtype)
    if world_size() == 1:
        return
    for m in model.modules():
        if hasattr(m, 'stats_sync'):
            m.stats_sync = sum_over_ranks
    if augment is not None:
        augment.std_fn = global_std

