"""Train and eval steps.

PyTorch counterpart of ``inferbiomechanics_tpu/train/step.py``: one step is
forward, loss, all reported metrics, backward and the optimizer update, on
the packed ``[B, T, C]`` batch tensors straight from the data layer (label
dicts are column-slice views). The state is updated in place and the step
returns the metrics, which stay on the device.

``grad_accum > 1`` splits the batch into that many equal microbatches,
runs them one after the other (activation memory of one microbatch) and
averages gradients and metrics before the single update. A batchnorm model's
running statistics go from microbatch to microbatch, as the JAX package's
scan carries them.

``augment`` (``train/augment.py::Augmenter``) mirrors and noises each
(micro)batch inside the step, before the forward, from the state's
augmentation generator (or the ``aug_draws`` seam); eval steps never
augment.

The chunked dispatch (``make_chunked_train_step`` for the host-loader tier,
``device_data.make_device_chunked_step`` for the device-resident one) is the
counterpart of the JAX package's K-step ``lax.scan``: K steps' inputs go to
the device in one copy, each step is a replay of the step captured once as a
CUDA graph (:class:`GraphedStep`), and the K steps' metrics come back in one
copy. On the CPU the same call runs the K steps eagerly. Either way the
result is bitwise that of K calls of the per-step function.

``make_eval_chunk_runner`` is the counterpart of the JAX ``analyze``'s
``lax.scan`` chunk: K same-shape batches uploaded in one copy and run
through the eval step one after the other, their metrics kept on the device
and brought to the host in one copy. ``make_graphed_chunk_runner`` does the
same for an eval function of its inputs alone, each batch a replay of the
function captured once a shape as a CUDA graph (:class:`GraphedEval`): the
analytical baseline's step, thousands of small launches a batch.

Data parallelism over processes (``parallel/dist.py``) adds the gradient
all-reduce between the backward and the update of every step, eager or
captured (:func:`as_train_step`).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from inferbiomechanics_tpu_torch.data.dataset import unpack
from inferbiomechanics_tpu_torch.loss.evaluator import LossConfig, loss_and_metrics
from inferbiomechanics_tpu_torch.train.augment import (
    AugmentDraws, Augmenter, generator_aug_draws, maybe_augment,
)
from inferbiomechanics_tpu_torch.train.optimizers import Optimizer
from inferbiomechanics_tpu_torch.train.state import TrainState

logger = logging.getLogger(__name__)

Metrics = Dict[str, torch.Tensor]
Spec = Tuple[Tuple[int, ...], torch.dtype]

# graph replays of train steps so far, and captures (for checking that a
# path went through the captured step); the same for eval functions
replays = 0
captures = 0
eval_replays = 0
eval_captures = 0


def accumulate_grads(state: TrainState, grad_accum: int, batch_size: int,
                     loss_for: Callable[[slice], Tuple[torch.Tensor, Metrics]]
                     ) -> Metrics:
    """Leave on the parameters the gradient of the mean loss over
    ``grad_accum`` equal microbatches, and return the metrics averaged over
    them. ``loss_for(rows)`` is the loss and metrics of the microbatch made
    of those rows of the batch."""
    if batch_size % grad_accum:
        raise ValueError(f'batch size {batch_size} not divisible by '
                         f'--grad-accum-steps {grad_accum}')
    mb = batch_size // grad_accum
    state.optimizer.zero_grad(set_to_none=True)
    history = []
    for k in range(grad_accum):
        loss, metrics = loss_for(slice(k * mb, (k + 1) * mb))
        (loss / grad_accum).backward()      # gradients add up on .grad
        history.append(metrics)
    if grad_accum == 1:
        return history[0]
    return {k: torch.stack([m[k] for m in history]).mean(0) for k in history[0]}


def aug_draws_of(state: TrainState, aug_draws: Optional[AugmentDraws]) -> AugmentDraws:
    """A step's augmentation draws: ``aug_draws`` when given (the seam tests
    feed), else the state's augmentation generator's (the global batch's
    draws, this rank's rows, under data parallelism)."""
    if aug_draws is not None:
        return aug_draws
    return generator_aug_draws(state.aug_gen, getattr(state, 'draw_shard', None))


def as_train_step(grads: Callable[..., Metrics]) -> Callable[..., Metrics]:
    """The eager step around ``grads(state, *inputs) -> metrics`` (forward,
    loss, backward; gradients left on the parameters): the per-step
    generators reseeded for the step, then ``grads``, then the state's
    gradient all-reduce when it has one (``TrainState.grad_sync``: after
    the backward and any accumulation, before the update, as the JAX
    package reduces before optax's chain), then the update. ``step.grads``
    is ``grads`` with the all-reduce, which a captured step records with the
    update."""

    def synced(state: TrainState, *inputs: torch.Tensor) -> Metrics:
        metrics = grads(state, *inputs)
        sync = getattr(state, 'grad_sync', None)
        return metrics if sync is None else sync(metrics)

    def step(state: TrainState, *inputs: torch.Tensor) -> Metrics:
        state.reseed_generators()
        metrics = synced(state, *inputs)
        state.apply_gradients()
        return metrics

    step.grads = synced
    return step


def make_train_step(model, lab_offsets: Dict[str, Tuple[int, int]],
                    loss_config: LossConfig, grad_accum: int = 1,
                    augment: Optional[Augmenter] = None,
                    aug_draws: Optional[AugmentDraws] = None) -> Callable:
    """Build ``step(state, inputs, labels) -> metrics`` (``state`` is
    updated in place)."""

    def grads(state: TrainState, batch_inputs: torch.Tensor,
              batch_labels: torch.Tensor) -> Metrics:
        model.train()
        draws = aug_draws_of(state, aug_draws)

        def loss_for(rows: slice):
            inputs, labels = maybe_augment(augment, batch_inputs[rows],
                                           batch_labels[rows], draws)
            return loss_and_metrics(model(inputs), unpack(labels, lab_offsets),
                                    loss_config)

        return accumulate_grads(state, grad_accum, batch_inputs.shape[0], loss_for)

    return as_train_step(grads)


class RowLayout:
    """Tensors of fixed shapes and dtypes laid out in one row of bytes, each
    on a 16-byte boundary (the kernels read their inputs in 16-byte
    pieces); a chunk's K steps are K such rows."""

    def __init__(self, specs: Sequence[Spec]):
        self.specs = [(tuple(shape), dtype) for shape, dtype in specs]
        self.offsets, self.sizes = [], []
        at = 0
        for shape, dtype in self.specs:
            size = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
            self.offsets.append(at)
            self.sizes.append(size)
            at += -(-size // 16) * 16
        self.nbytes = max(at, 16)

    def views(self, rows: torch.Tensor) -> List[torch.Tensor]:
        """The tensors in ``rows`` (uint8 [..., nbytes]) as views, each
        [..., *shape]."""
        lead = rows.shape[:-1]
        return [rows[..., at:at + size].view(dtype).view(*lead, *shape)
                for (shape, dtype), at, size in zip(self.specs, self.offsets, self.sizes)]


class MetricLayout:
    """A step's metrics as one flat float32 vector, and back."""

    def __init__(self, metrics: Metrics):
        self.items = [(k, tuple(v.shape)) for k, v in metrics.items()]

    def flatten(self, metrics: Metrics) -> torch.Tensor:
        return torch.cat([metrics[k].reshape(-1).float() for k, _ in self.items])

    def split(self, flat):
        """``flat`` [..., width] (an array or a tensor) -> each metric
        [..., *shape]."""
        out, at, lead = {}, 0, flat.shape[:-1]
        for k, shape in self.items:
            n = int(np.prod(shape))
            out[k] = flat[..., at:at + n].reshape(lead + shape)
            at += n
        return out


class ChunkMetrics:
    """A chunk's per-step metrics ([K, width] float32, a row a step) on
    their way to the host. :meth:`rows` waits for them, copies them once and
    returns each step's metrics as host arrays by name, in step order."""

    def __init__(self, layout: MetricLayout, flat: torch.Tensor,
                 event: Optional[torch.cuda.Event] = None):
        self.layout, self.flat, self.event = layout, flat, event

    def rows(self) -> List[Dict[str, np.ndarray]]:
        if self.event is not None:
            self.event.synchronize()
        flat = self.flat.numpy().copy()
        return [self.layout.split(row) for row in flat]


class GraphedStep:
    """A train step captured once as a CUDA graph, and replayed.

    The graph holds ``grads(state, *inputs)``, the optimizer's update, the
    state's EMA update (when it keeps one) and the metrics flattened into
    one vector; a batchnorm model's running statistics are updated in place
    inside it. It reads its inputs and the
    optimizer's step-dependent values from one static row on the device
    (:class:`RowLayout` of ``specs`` and the ``n_scalars`` values of
    :attr:`Optimizer.scalars`; a sweep's optimizer has K rows of them), which
    :meth:`step` fills by one device-to-device copy before each replay. The
    host's part of a step is what the graph cannot hold: the model's
    training flag, the per-step generators' seeds (the dropout and the
    augmentation generators are registered with the graph, so a replay draws
    what an eager step would), the optimizer's count and the step count.

    The first :attr:`WARMUP_STEPS` steps run eagerly on the capture stream.
    They are the run's own steps, not extra ones, and they make every lazy
    allocation (optimizer state, library handles and workspaces) before the
    capture. Allocations inside the capture (activations, gradients, the
    kernels' outputs and workspaces) come from the graph's own pool and keep
    their addresses. A kernel's wrapper counts a launch where it calls the
    kernel: at each eager step, and once at the capture, which records the
    launch into the graph. A replay runs no wrapper; the kernels it runs show
    by name in a profiler trace. A capture that fails raises; nothing falls
    back to eager steps.
    """

    WARMUP_STEPS = 2

    def __init__(self, grads: Callable[..., Metrics], specs: Sequence[Spec], device,
                 n_scalars: int = Optimizer.N_SCALARS):
        self.grads = grads
        self.layout = RowLayout([*specs, ((n_scalars,), torch.float32)])
        self.device = torch.device(device)
        self.row = torch.zeros(self.layout.nbytes, dtype=torch.uint8, device=self.device)
        *self.inputs, self.scalars = self.layout.views(self.row)
        self.stream = torch.cuda.Stream(self.device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.flat: Optional[torch.Tensor] = None
        self.metric_layout: Optional[MetricLayout] = None
        self.eager_steps = 0

    def _body(self, state: TrainState) -> torch.Tensor:
        state.optimizer.scalars_on(self.device).copy_(self.scalars)
        metrics = self.grads(state, *self.inputs)
        state.optimizer.update()
        state.update_ema()
        if self.metric_layout is None:
            self.metric_layout = MetricLayout(metrics)
        return self.metric_layout.flatten(metrics)

    def _capture(self, state: TrainState) -> None:
        global captures
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        for gen in state.generators():
            graph.register_generator_state(gen)
        # torch.cuda.graph() would also collect garbage and empty the
        # allocator's cache first, a tenth of a second in a large process
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            graph.capture_begin(capture_error_mode='thread_local')
            try:
                self.flat = self._body(state)
            finally:
                graph.capture_end()
        current.wait_stream(self.stream)
        self.graph = graph
        captures += 1
        logger.info('train step captured as a CUDA graph in %.3f s', time.perf_counter() - t0)

    def step(self, state: TrainState, row: torch.Tensor) -> torch.Tensor:
        """One step on ``row`` (uint8 [nbytes] on the device: the step's
        inputs and optimizer scalars). Returns its flat metrics, valid until
        the next step."""
        global replays
        state.model.train()
        state.reseed_generators()
        self.row.copy_(row)
        if self.graph is None and self.eager_steps < self.WARMUP_STEPS:
            current = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                flat = self._body(state)
            current.wait_stream(self.stream)
            self.eager_steps += 1
        else:
            if self.graph is None:
                self._capture(state)
            self.graph.replay()
            replays += 1
            flat = self.flat
        state.optimizer.advance()
        state.step += 1
        return flat


class ChunkedStep:
    """``chunk(state, *inputs) -> ChunkMetrics``: the K steps of a chunk.
    Each input is [K, ...] on the host (an array, or a sequence of K arrays)
    and becomes, step by step, the argument of ``step`` in ``dtypes``.

    On the CPU: K calls of the eager ``step``. On a CUDA device: the K
    steps' inputs, in ``dtypes`` (a float32 input asked for in bf16 is
    rounded on the host), and their optimizer scalars go up in one copy of K
    pinned rows, on a stream of its own; each step copies its row into the
    static row and replays the step's graph (:class:`GraphedStep`, one a
    shape of the inputs); the K steps' metrics come back to pinned host
    memory in one copy, and nothing waits for them until
    :meth:`ChunkMetrics.rows`.
    """

    def __init__(self, step: Callable[..., Metrics], dtypes: Sequence[torch.dtype], device):
        self.step = step
        self.dtypes = tuple(dtypes)
        self.device = torch.device(device)
        self.graphs: Dict[Tuple, GraphedStep] = {}
        self.upload: Optional[torch.cuda.Stream] = None

    def __call__(self, state: TrainState, *inputs) -> ChunkMetrics:
        if len(inputs) != len(self.dtypes):
            raise ValueError(f'expected {len(self.dtypes)} inputs, got {len(inputs)}')
        k = len(inputs[0])
        if k == 0 or any(len(a) != k for a in inputs):
            raise ValueError(f'inputs of {[len(a) for a in inputs]} steps')
        if self.device.type == 'cpu':
            return self._eager(state, inputs, k)
        if self.device.type != 'cuda':
            raise ValueError(f'no chunked step for device {self.device}')
        return self._replayed(state, inputs, k)

    def _host(self, a, j: int, dtype) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a[j])).to(dtype)

    def _eager(self, state: TrainState, inputs, k: int) -> ChunkMetrics:
        layout, flat = None, []
        for j in range(k):
            metrics = self.step(state, *(self._host(a, j, dt)
                                         for a, dt in zip(inputs, self.dtypes)))
            layout = layout or MetricLayout(metrics)
            flat.append(layout.flatten(metrics))
        return ChunkMetrics(layout, torch.stack(flat))

    def _replayed(self, state: TrainState, inputs, k: int) -> ChunkMetrics:
        shapes = tuple(tuple(np.shape(a[0])) for a in inputs)
        graph = self.graphs.get(shapes)
        if graph is None:
            graph = self.graphs[shapes] = GraphedStep(
                self.step.grads, list(zip(shapes, self.dtypes)), self.device,
                n_scalars=len(state.optimizer.next_scalars()))
        host = torch.empty((k, graph.layout.nbytes), dtype=torch.uint8, pin_memory=True)
        *columns, scalars = graph.layout.views(host)
        for a, col in zip(inputs, columns):
            for j in range(k):
                col[j].copy_(torch.from_numpy(np.asarray(a[j])))   # rounds to col's dtype
        scalars.copy_(torch.from_numpy(np.stack(
            [state.optimizer.next_scalars(ahead=j) for j in range(k)])))
        # the upload runs on a stream of its own, beside the replays of the
        # chunk before; the replays wait for it only
        current = torch.cuda.current_stream(self.device)
        if self.upload is None:
            self.upload = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self.upload):
            rows = host.to(self.device, non_blocking=True)
            uploaded = torch.cuda.Event()
            uploaded.record()
        current.wait_event(uploaded)
        rows.record_stream(current)
        out = None
        for j in range(k):
            flat = graph.step(state, rows[j])
            if out is None:
                out = torch.empty((k, flat.numel()), dtype=torch.float32, device=self.device)
            out[j].copy_(flat)
        back = torch.empty(out.shape, dtype=torch.float32, pin_memory=True)
        back.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return ChunkMetrics(graph.metric_layout, back, event)


def make_chunked_train_step(model, lab_offsets: Dict[str, Tuple[int, int]],
                            loss_config: LossConfig, grad_accum: int = 1,
                            input_dtype: torch.dtype = torch.float32,
                            device='cuda', augment: Optional[Augmenter] = None,
                            aug_draws: Optional[AugmentDraws] = None) -> ChunkedStep:
    """The host-loader tier's chunk: ``chunk(state, inputs [K, B, T, C],
    labels [K, B, ...]) -> ChunkMetrics`` from K host batches, bitwise K
    calls of :func:`make_train_step`'s step on those batches uploaded in
    ``input_dtype`` (``torch.bfloat16`` for ``--host-upload-dtype bf16``:
    half the bytes, and the models round their inputs to bf16 anyway; an
    augmented step noises them in that dtype, as the JAX package does)."""
    step = make_train_step(model, lab_offsets, loss_config, grad_accum=grad_accum,
                           augment=augment, aug_draws=aug_draws)
    return ChunkedStep(step, (input_dtype, torch.float32), device)


def make_eval_step(model, lab_offsets: Dict[str, Tuple[int, int]],
                   loss_config: LossConfig) -> Callable:
    """Build ``eval_step(state, inputs, labels) -> (outputs, metrics)``."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch_inputs: torch.Tensor,
                  batch_labels: torch.Tensor):
        model.eval()
        outputs = model(batch_inputs)
        _, metrics = loss_and_metrics(outputs, unpack(batch_labels, lab_offsets),
                                      loss_config)
        return outputs, metrics

    return eval_step


def _upload_rows(arrays: Sequence[np.ndarray], dtypes: Sequence[torch.dtype], device
                 ) -> Tuple[RowLayout, torch.Tensor]:
    """K same-shape host arrays each ([K, ...]) as K rows of one
    :class:`RowLayout` on ``device``, uploaded in one copy (from pinned
    memory to a CUDA device); each column is converted to its dtype."""
    device = torch.device(device)
    layout = RowLayout([(a.shape[1:], dt) for a, dt in zip(arrays, dtypes)])
    host = torch.zeros((len(arrays[0]), layout.nbytes), dtype=torch.uint8,
                       pin_memory=device.type == 'cuda')
    for col, a in zip(layout.views(host), arrays):
        col.copy_(torch.from_numpy(np.ascontiguousarray(a)))
    return layout, host.to(device, non_blocking=True)


def make_eval_chunk_runner(eval_step: Callable, device) -> Callable:
    """Build ``run(state, inputs, labels) -> metrics`` for K same-shape
    batches: ``inputs`` [K, B, T, C] and ``labels`` [K, B, ...] float32 host
    arrays, uploaded in one copy of K rows (:class:`RowLayout`); the K eval
    forwards run one after the other with their metrics on the device, then
    one device-to-host copy brings them all back as host arrays [K, ...] by
    metric."""

    def run(state, inputs: np.ndarray, labels: np.ndarray) -> Dict[str, np.ndarray]:
        layout, rows = _upload_rows((inputs, labels), (torch.float32, torch.float32), device)
        history = [eval_step(state, *layout.views(row))[1] for row in rows]
        metrics = MetricLayout(history[0])
        return metrics.split(torch.stack([metrics.flatten(m) for m in history]).cpu().numpy())

    return run


class GraphedEval:
    """``fn(*inputs) -> metrics`` captured once as a CUDA graph, and
    replayed; the inputs are the tensors of :class:`RowLayout` ``specs`` in
    one static row on the device, which :meth:`__call__` fills by one
    device-to-device copy.

    The first call runs ``fn`` eagerly on the capture stream: its result is
    the call's own, and it makes every lazy allocation (library handles,
    cached index tensors) before the capture. The second call captures and
    replays; later calls replay. A replay runs the captured kernels on the
    row's new contents, so its metrics are bitwise those of an eager call.
    ``fn`` must not copy from the host or branch on a tensor's value; a
    capture that fails raises, and nothing falls back to eager calls."""

    def __init__(self, fn: Callable[..., Metrics], specs: Sequence[Spec], device):
        self.fn = fn
        self.layout = RowLayout(specs)
        self.device = torch.device(device)
        self.row = torch.zeros(self.layout.nbytes, dtype=torch.uint8, device=self.device)
        self.inputs = self.layout.views(self.row)
        self.stream = torch.cuda.Stream(self.device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.flat: Optional[torch.Tensor] = None
        self.metric_layout: Optional[MetricLayout] = None

    def _body(self) -> torch.Tensor:
        metrics = self.fn(*self.inputs)
        if self.metric_layout is None:
            self.metric_layout = MetricLayout(metrics)
        return self.metric_layout.flatten(metrics)

    def __call__(self, row: torch.Tensor) -> torch.Tensor:
        """``fn`` on ``row`` (uint8 [nbytes] on the device); returns its flat
        metrics, valid until the next call."""
        self.row.copy_(row)
        return self._launch()

    def run(self, *tensors: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``fn`` on ``tensors`` (on the device, of the specs' shapes; each
        copied into its place in the row and converted to its dtype);
        returns its metrics by name, views valid until the next call."""
        for view, t in zip(self.inputs, tensors):
            view.copy_(t)
        flat = self._launch()
        return self.metric_layout.split(flat)

    def _launch(self) -> torch.Tensor:
        global eval_replays, eval_captures
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        if self.metric_layout is None:
            with torch.cuda.stream(self.stream):
                flat = self._body()
            current.wait_stream(self.stream)
            return flat
        if self.graph is None:
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(self.stream):
                graph.capture_begin(capture_error_mode='thread_local')
                try:
                    self.flat = self._body()
                finally:
                    graph.capture_end()
            self.graph = graph
            eval_captures += 1
            logger.info('eval function captured as a CUDA graph in %.3f s',
                        time.perf_counter() - t0)
        with torch.cuda.stream(self.stream):
            self.graph.replay()
        eval_replays += 1
        current.wait_stream(self.stream)
        return self.flat


def make_graphed_chunk_runner(fn: Callable[..., Metrics], dtypes: Sequence[torch.dtype],
                              device) -> Callable:
    """Build ``run(*arrays) -> metrics`` for K same-shape calls of
    ``fn(*inputs) -> metrics``: each array [K, ...] on the host, converted
    to its entry of ``dtypes``, uploaded in one copy of K rows; the metrics
    come back in one copy, as host arrays [K, ...] by metric. On a CUDA
    device each call is a :class:`GraphedEval` replay (one graph a shape of
    the inputs, in ``run.graphs`` by specs); on the CPU ``fn`` runs
    eagerly."""
    device = torch.device(device)
    graphs: Dict[Tuple, GraphedEval] = {}

    def run(*arrays: np.ndarray) -> Dict[str, np.ndarray]:
        layout, rows = _upload_rows(arrays, dtypes, device)
        if device.type != 'cuda':
            history = [fn(*layout.views(row)) for row in rows]
            metrics = MetricLayout(history[0])
            return metrics.split(torch.stack([metrics.flatten(m) for m in history]).numpy())
        graph = graphs.get(tuple(layout.specs))
        if graph is None:
            graph = graphs[tuple(layout.specs)] = GraphedEval(fn, layout.specs, device)
        out = None
        for j, row in enumerate(rows):
            flat = graph(row)
            if out is None:
                out = torch.empty((len(rows), flat.numel()), dtype=torch.float32,
                                  device=device)
            out[j].copy_(flat)
        return graph.metric_layout.split(out.cpu().numpy())

    run.graphs = graphs
    return run
