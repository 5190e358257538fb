"""One typed config schema shared by every entry point.

The port's own copy of ``inferbiomechanics_tpu/config.py``: the same flags
with the same defaults (``tests/test_torch_data.py`` holds the two
together), so a command line means the same to both packages.

The reference re-declares ~20 argparse flags per command with drifting
defaults (SURVEY.md §5 "Config / flag system"); here a single dataclass
carries the schema, each CLI command binds it to argparse with the
reference's flag names (train.py:24-69), and the full config is dumped to
the metric logger for provenance.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Config:
    # data
    dataset_home: str = '../data'
    window_size: int = 50           # --history-len
    stride: int = 5
    output_data_format: str = 'last_frame'   # {all_frames, last_frame}
    trial_filter: Optional[str] = None
    short: bool = False
    data_loading_workers: int = 1
    geometry_folder: str = ''

    # model
    model_type: str = 'feedforward'  # {analytical,feedforward,groundlink,transformer,diffusion}
    checkpoint_dir: str = '../checkpoints'
    # beyond parity: transfer learning. --init-from-checkpoint warm-starts
    # the params (fresh optimizer, epoch 0 — NOT a resume; ignored when
    # checkpoint_dir already has resume checkpoints); --freeze-params
    # holds regex-matched parameter subtrees bitwise at their initial
    # values while the rest train.
    init_from_checkpoint: Optional[str] = None
    freeze_params: List[str] = field(default_factory=list)
    hidden_dims: List[int] = field(default_factory=lambda: [512, 512])
    activation: str = 'sigmoid'
    # feedforward weight-init style: 'torch' reproduces the reference's
    # shipped nn.Linear init (the PARITY_RMSE.md choice); 'lecun' is the
    # flax default (better GRF, worse CoP on the synthetic benchmark)
    init_style: str = 'torch'
    dropout: bool = False
    dropout_prob: float = 0.0
    batchnorm: bool = False
    d_model: int = 256
    num_layers: int = 4
    num_heads: int = 8
    # 'vpu' (broadcast-reduce attention over the short window) | 'flax'
    # (nn.MultiHeadDotProductAttention; JAX package only)
    attn_impl: str = 'vpu'
    # inference-only: run vpu transformer checkpoints through the fused
    # encoder-layer kernel (bf16-residual-level numeric difference)
    fused_inference: bool = False
    # groundlink conv lowering in the JAX package: 'xla' (nn.Conv) |
    # 'banded' (one matmul per conv layer)
    conv_impl: str = 'xla'

    # optimization
    learning_rate: float = 1e-4
    opt_type: str = 'rmsprop'
    # beyond parity: adamw decoupled weight decay + global-norm gradient
    # clipping (0 = off)
    weight_decay: float = 1e-4
    grad_clip_norm: float = 0.0
    epochs: int = 10
    batch_size: int = 64
    # seeds init, dropout, per-epoch shuffles, diffusion noise (the
    # reference has no seed control; runs were irreproducible)
    seed: int = 0
    # beyond parity: LR schedules (reference trains at fixed LR only)
    lr_schedule: str = 'constant'   # {constant,cosine,warmup_cosine,linear}
    lr_decay_steps: int = 0         # total steps to decay over (required
    lr_warmup_steps: int = 0        # for non-constant schedules)
    # beyond parity: dtype of the cross-device gradient all-reduce on
    # multi-chip data-parallel meshes. 'bf16' halves the ICI bytes of
    # dp training's dominant collective (explicit shard_map psum; GSPMD
    # cannot express a reduced-precision reduction). Not with batchnorm.
    grad_allreduce_dtype: str = 'f32'   # {f32,bf16}
    # beyond parity: split each batch into N sequential microbatches and
    # average the gradients before the optimizer update — activation
    # memory scales with batch_size/N, so effective batches far beyond
    # HBM fit. batch_size must divide evenly. Dropout draws fresh noise
    # per microbatch (same distribution, not bitwise == one big batch).
    grad_accum_steps: int = 1

    # beyond parity: chunked host dispatch — on the host-loader tier,
    # prefetch K batches, upload them as ONE [K, B, ...] array, and run
    # a K-step lax.scan per dispatch (amortizes upload latency + program
    # launch by K; semantics identical to K per-step calls). 1 = legacy
    # per-batch dispatch. Ignored on the device-resident/sharded/stream
    # tiers, which already scan on-device.
    host_chunk_steps: int = 1
    # host-tier INPUT upload dtype: 'bf16' halves the host->device bytes
    # of the upload.
    # Numerically free when the model computes in bf16 (the default —
    # inputs are cast on device anyway); labels always ship f32 because
    # the loss consumes them at f32.
    host_upload_dtype: str = 'f32'
    # device-resident tier: K train steps per dispatch (one lax.scan
    # program consuming a [K, B] index block — same index bytes as K
    # per-step dispatches, in one transfer, with the per-dispatch
    # overhead amortized by K; numerics bitwise-identical). DEFAULT ON:
    # this is the flagship path's throughput lever. 1 restores per-step
    # dispatch (finer-grained
    # mid-epoch checkpoints/logging). Multi-process runs and
    # --grad-allreduce-dtype fall back to per-step automatically.
    device_chunk_steps: int = 64

    # beyond parity: on-device training-data augmentation
    # (train/augment.py — compiled into the train step on every tier;
    # dev eval never augments). Mirror = per-window sagittal reflection
    # with skeleton-derived channel permutation/sign; noise = relative
    # Gaussian noise on the kinematic inputs.
    augment_mirror: bool = False
    augment_noise_std: float = 0.0
    mirror_lateral_axis: int = 2

    # loss component selection (reference train.py:58-65: the train
    # entry point defaults to EVERY component of all four loss vectors;
    # analyze.py:44-47 instead defaults to vertical GRF only — that
    # override lives in cli/analyze_cmd.py)
    predict_grf_components: List[int] = field(default_factory=lambda: list(range(6)))
    predict_cop_components: List[int] = field(default_factory=lambda: list(range(6)))
    predict_moment_components: List[int] = field(default_factory=lambda: list(range(6)))
    predict_wrench_components: List[int] = field(default_factory=lambda: list(range(12)))

    # reporting
    no_wandb: bool = False
    compute_report: bool = False
    checkpoint_every_batches: int = 1000
    log_every_batches: int = 100
    # beyond parity: best.ckpt on dev-loss improvement / stop after N
    # dev evals without improvement (0 = disabled)
    keep_best: bool = False
    early_stop_patience: int = 0
    # retention: keep only the newest N epoch_*_batch_* checkpoints
    # (0 = keep all, the reference behavior); best.ckpt is never pruned
    keep_checkpoints: int = 0
    # beyond parity: serialize + write checkpoints on a background thread
    # so only the device->host snapshot blocks training (the reference
    # stalls its loop for every torch.save, train.py:270-278)
    async_checkpoint: bool = False

    # auxiliary-head supervision (transformer tau/COM-acc/contact heads)
    aux_tau_weight: float = 0.0
    aux_com_acc_weight: float = 0.0
    aux_contact_weight: float = 0.0

    # diffusion
    diffusion_timesteps: int = 1000
    # beyond parity: exponential moving average of the denoiser params
    # (standard diffusion practice; 0 = off). The EMA tree rides in the
    # checkpoint under 'ema_params'; evaluate/serve it with --use-ema.
    ema_decay: float = 0.0
    # beyond parity: classifier-free guidance. cond_dropout zeroes each
    # training sample's conditioning windows with this probability (the
    # model learns the unconditional score too); guidance_scale != 1
    # applies eps_u + s·(eps_c − eps_u) at sampling time (analyze /
    # serve / export).
    cond_dropout: float = 0.0
    guidance_scale: float = 1.0

    # parallelism
    model_parallel: int = 1
    # pipeline parallelism (transformer only, parallel/pipeline.py):
    # encoder layers staged over a 'pipe' mesh axis with a GPipe
    # microbatch schedule. Devices split into (data, pipe); runs the host
    # loader tier. 1 = off. pipeline_microbatches 0 = 2 x stages.
    pipeline_parallel: int = 1
    pipeline_microbatches: int = 0

    # data placement: 'auto' puts the packed dataset in HBM and gathers
    # windows on-device when it fits (train/device_data.py), falling back
    # to pod-sharded residency (trials sharded across the mesh's data
    # axis, train/sharded_data.py) when it only fits the COMBINED HBM of
    # a multi-chip mesh; 'on' requires single-chip residency; 'sharded'
    # forces the pod-sharded tier; 'stream' the segment streamer; 'off'
    # the host PrefetchLoader path.
    device_data: str = 'auto'
    device_data_max_bytes: int = 4_000_000_000
    # False = keep input features ON DISK (mmap) and featurize per trial
    # on demand. With --device-data sharded on a multi-host pod each
    # process then materializes only its own shards' trials, so HOST RAM
    # scales with the process count like HBM scales with the mesh.
    materialize_features: bool = True
    # window-major packed feature copy in HBM: per-step batch gather is
    # ONE take of contiguous rows instead of T scattered row reads.
    # 'auto' packs when frame-major + packed fit device_data_max_bytes;
    # costs ~window/stride x the frame-major features in HBM.
    pack_windows: str = 'auto'

    # profiling (SURVEY.md §5: reference has none; the port adds the torch profiler)
    profile: bool = False
    profile_dir: str = 'outputs/profile'

    @property
    def history_len(self) -> int:
        return self.window_size


def add_config_flags(parser: argparse.ArgumentParser, defaults: Optional[Config] = None) -> None:
    """Bind the schema to argparse with the reference's flag names."""
    d = defaults or Config()
    parser.add_argument('--dataset-home', type=str, default=d.dataset_home,
                        help='The path to the AddBiomechanics dataset.')
    parser.add_argument('--model-type', type=str, default=d.model_type,
                        choices=['analytical', 'feedforward', 'groundlink',
                                 'transformer', 'diffusion'])
    parser.add_argument('--output-data-format', type=str, default=d.output_data_format,
                        choices=['all_frames', 'last_frame'])
    parser.add_argument('--no-wandb', action='store_true', default=d.no_wandb)
    parser.add_argument('--checkpoint-dir', type=str, default=d.checkpoint_dir)
    parser.add_argument('--geometry-folder', type=str, default=d.geometry_folder)
    parser.add_argument('--history-len', type=int, default=d.window_size,
                        help='Number of frames of context (raw frames).')
    parser.add_argument('--stride', type=int, default=d.stride)
    parser.add_argument('--learning-rate', type=float, default=d.learning_rate)
    parser.add_argument('--dropout', action='store_true', default=d.dropout)
    parser.add_argument('--dropout-prob', type=float, default=d.dropout_prob)
    parser.add_argument('--hidden-dims', type=int, nargs='+', default=d.hidden_dims)
    parser.add_argument('--batchnorm', action='store_true', default=d.batchnorm)
    parser.add_argument('--activation', type=str, default=d.activation)
    parser.add_argument('--init-style', type=str, default=d.init_style,
                        choices=('torch', 'lecun'),
                        help="feedforward weight init: 'torch' = reference "
                             "nn.Linear parity (PARITY_RMSE.md), 'lecun' = "
                             "flax default")
    parser.add_argument('--epochs', type=int, default=d.epochs)
    parser.add_argument('--opt-type', type=str, default=d.opt_type)
    parser.add_argument('--weight-decay', type=float, default=d.weight_decay,
                        help='Decoupled weight decay (adamw only)')
    parser.add_argument('--grad-clip-norm', type=float,
                        default=d.grad_clip_norm,
                        help='Clip gradients to this global norm before '
                             'the optimizer update (0 = off)')
    parser.add_argument('--batch-size', type=int, default=d.batch_size)
    parser.add_argument('--seed', type=int, default=d.seed,
                        help='Seed for init/dropout/shuffles — two runs '
                             'with the same seed and flags are '
                             'reproducible (reference has no seed control)')
    parser.add_argument('--lr-schedule', type=str, default=d.lr_schedule,
                        choices=['constant', 'cosine', 'warmup_cosine',
                                 'linear'],
                        help='LR schedule (beyond parity; reference is '
                             'fixed-LR)')
    parser.add_argument('--lr-decay-steps', type=int, default=d.lr_decay_steps,
                        help='Total steps to decay over (non-constant '
                             'schedules)')
    parser.add_argument('--lr-warmup-steps', type=int,
                        default=d.lr_warmup_steps)
    parser.add_argument('--grad-allreduce-dtype', type=str,
                        default=d.grad_allreduce_dtype,
                        choices=['f32', 'bf16'],
                        help='Gradient all-reduce dtype on multi-chip '
                             'data-parallel meshes; bf16 halves the ICI '
                             'bytes of the dominant dp collective')
    parser.add_argument('--grad-accum-steps', type=int,
                        default=d.grad_accum_steps,
                        help='Split each batch into N sequential '
                             'microbatches, averaging gradients before the '
                             'update — effective batches beyond activation-'
                             'memory fit (batch-size must divide evenly)')
    parser.add_argument('--host-chunk-steps', type=int,
                        default=d.host_chunk_steps,
                        help='Host-loader tier: prefetch K batches, upload '
                             'once, and run a K-step on-device scan per '
                             'dispatch (amortizes upload + launch costs; '
                             'identical numerics). 1 = per-batch dispatch')
    parser.add_argument('--device-chunk-steps', type=int,
                        default=d.device_chunk_steps,
                        help='Device-resident tier: K train steps per '
                             'dispatch (one scan program per [K, B] index '
                             'block; identical numerics, ~K x less dispatch '
                             'overhead). 1 = per-step dispatch')
    parser.add_argument('--host-upload-dtype', type=str,
                        default=d.host_upload_dtype,
                        choices=('f32', 'bf16'),
                        help='Host-loader tier: upload training INPUTS as '
                             'bf16 (half the bytes; free when the model '
                             'computes in bf16). Labels always ship f32')
    parser.add_argument('--keep-best', action='store_true',
                        default=d.keep_best,
                        help='Save best.ckpt whenever the dev loss improves '
                             '(resume still uses the latest epoch_* ckpt)')
    parser.add_argument('--early-stop-patience', type=int,
                        default=d.early_stop_patience,
                        help='Stop after N dev evals without improvement '
                             '(0 = off)')
    parser.add_argument('--keep-checkpoints', type=int,
                        default=d.keep_checkpoints,
                        help='Keep only the newest N epoch_* checkpoints '
                             '(0 = keep all, reference behavior; best.ckpt '
                             'is never pruned)')
    parser.add_argument('--init-from-checkpoint', type=str,
                        default=d.init_from_checkpoint,
                        help='Warm-start the params from this checkpoint '
                             'file (fresh optimizer, epoch 0 — transfer '
                             'learning, not a resume; ignored when '
                             '--checkpoint-dir already has resume '
                             'checkpoints): the port\'s .torch.pt or the JAX '
                             'package\'s .ckpt. Use python -m '
                             'inferbiomechanics_tpu_torch convert-checkpoint '
                             'first for reference .pt sources.')
    parser.add_argument('--freeze-params', type=str, nargs='+',
                        default=d.freeze_params,
                        help='Regexes over /-joined parameter paths (e.g. '
                             '"layers_0" "encoder/.*/kernel"); matching '
                             'subtrees stay bitwise at their initial '
                             'values while the rest train')
    parser.add_argument('--async-checkpoint', action='store_true',
                        default=d.async_checkpoint,
                        help='Write checkpoints on a background thread; '
                             'training only blocks for the device->host '
                             'snapshot, not serialization/disk')
    parser.add_argument('--augment-mirror', action='store_true',
                        default=d.augment_mirror,
                        help='Mirror each training window across the '
                             'sagittal plane with probability 0.5 '
                             '(left/right channels swapped with the '
                             'reflection sign rules, labels included; '
                             'compiled into the train step, dev eval '
                             'never augmented)')
    parser.add_argument('--augment-noise-std', type=float,
                        default=d.augment_noise_std,
                        help='Gaussian noise on the kinematic inputs, '
                             'relative to each channel\'s batch std '
                             '(e.g. 0.02; 0 = off)')
    parser.add_argument('--mirror-lateral-axis', type=int,
                        default=d.mirror_lateral_axis, choices=[0, 1, 2],
                        help='Which root-frame axis is lateral for '
                             '--augment-mirror (default 2 = z, the '
                             'OpenSim convention)')
    parser.add_argument('--short', action='store_true', default=d.short)
    parser.add_argument('--data-loading-workers', type=int, default=d.data_loading_workers)
    parser.add_argument('--predict-grf-components', type=int, nargs='*',
                        default=d.predict_grf_components)
    parser.add_argument('--predict-cop-components', type=int, nargs='*',
                        default=d.predict_cop_components)
    parser.add_argument('--predict-moment-components', type=int, nargs='*',
                        default=d.predict_moment_components)
    parser.add_argument('--predict-wrench-components', type=int, nargs='*',
                        default=d.predict_wrench_components)
    parser.add_argument('--trial-filter', type=str, default=d.trial_filter)
    parser.add_argument('--device', type=str, default=None,
                        help="Reference-compat (train.py --device): 'cpu' "
                             "pins the CPU backend; any other value is "
                             "accepted and ignored — device placement is "
                             "automatic on TPU")
    parser.add_argument('--compute-report', action='store_true', default=d.compute_report)
    parser.add_argument('--d-model', type=int, default=d.d_model)
    parser.add_argument('--num-layers', type=int, default=d.num_layers)
    parser.add_argument('--num-heads', type=int, default=d.num_heads)
    parser.add_argument('--attn-impl', type=str, default=d.attn_impl,
                        choices=['vpu', 'flax', 'pallas'],
                        help='Transformer attention implementation')
    parser.add_argument('--fused-inference', action='store_true',
                        default=d.fused_inference,
                        help='Serve vpu transformer checkpoints through the '
                             'fused encoder-layer kernel')
    parser.add_argument('--conv-impl', type=str, default=d.conv_impl,
                        choices=['xla', 'banded'],
                        help='GroundLink conv lowering (checkpoints are '
                             'interchangeable between the two)')
    parser.add_argument('--diffusion-timesteps', type=int, default=d.diffusion_timesteps)
    parser.add_argument('--ema-decay', type=float, default=d.ema_decay,
                        help='Diffusion: track an exponential moving '
                             'average of the denoiser params (e.g. 0.999; '
                             '0 = off); saved in checkpoints as '
                             'ema_params, evaluated with --use-ema')
    parser.add_argument('--cond-dropout', type=float, default=d.cond_dropout,
                        help='Diffusion: zero each training sample\'s '
                             'conditioning with this probability '
                             '(classifier-free guidance training, e.g. 0.1)')
    parser.add_argument('--guidance-scale', type=float,
                        default=d.guidance_scale,
                        help='Diffusion sampling: classifier-free guidance '
                             'scale (1 = plain conditional; needs a '
                             'checkpoint trained with --cond-dropout)')
    parser.add_argument('--aux-tau-weight', type=float, default=d.aux_tau_weight,
                        help='Weight of the joint-torque aux loss (transformer)')
    parser.add_argument('--aux-com-acc-weight', type=float, default=d.aux_com_acc_weight)
    parser.add_argument('--aux-contact-weight', type=float, default=d.aux_contact_weight)
    parser.add_argument('--model-parallel', type=int, default=d.model_parallel)
    parser.add_argument('--pipeline-parallel', type=int,
                        default=d.pipeline_parallel,
                        help='Stage the transformer encoder over this many '
                             'pipeline devices (GPipe microbatch schedule '
                             'over a (data, pipe) mesh); 1 = off')
    parser.add_argument('--pipeline-microbatches', type=int,
                        default=d.pipeline_microbatches,
                        help='Microbatches per pipelined step '
                             '(0 = 2 x pipeline stages)')
    parser.add_argument('--profile', action='store_true', default=d.profile,
                        help='Capture a torch profiler trace of the first epoch')
    parser.add_argument('--profile-dir', type=str, default=d.profile_dir)
    parser.add_argument('--device-data', type=str, default=d.device_data,
                        choices=['auto', 'on', 'off', 'sharded', 'stream'],
                        help='HBM-resident dataset with on-device window gather '
                             '(sharded = trials split across the data axis, '
                             'HBM capacity scales with the mesh)')
    parser.add_argument('--device-data-max-bytes', type=int,
                        default=d.device_data_max_bytes,
                        help='HBM budget for the resident dataset tiers: '
                             'auto-residency threshold, packing gate, and '
                             'the streaming tier\'s segment size')
    parser.add_argument('--pack-windows', type=str, default=d.pack_windows,
                        choices=['auto', 'on', 'off'],
                        help='window-major packed feature copy in device '
                             'memory (one contiguous take per batch)')
    parser.add_argument('--no-materialize-features', action='store_false',
                        dest='materialize_features',
                        default=d.materialize_features,
                        help='Keep input features on disk, featurizing per '
                             'trial on demand; with --device-data sharded '
                             'on multi-host, each process materializes only '
                             'its own shards (host RAM scales with the pod)')


def config_from_args(args: argparse.Namespace) -> Config:
    cfg = Config()
    mapping = {
        'dataset_home': 'dataset_home', 'model_type': 'model_type',
        'output_data_format': 'output_data_format', 'no_wandb': 'no_wandb',
        'checkpoint_dir': 'checkpoint_dir', 'geometry_folder': 'geometry_folder',
        'window_size': 'history_len', 'stride': 'stride',
        'learning_rate': 'learning_rate', 'dropout': 'dropout',
        'dropout_prob': 'dropout_prob', 'hidden_dims': 'hidden_dims',
        'batchnorm': 'batchnorm', 'activation': 'activation',
        'epochs': 'epochs', 'opt_type': 'opt_type', 'batch_size': 'batch_size',
        'seed': 'seed', 'lr_schedule': 'lr_schedule',
        'lr_decay_steps': 'lr_decay_steps',
        'lr_warmup_steps': 'lr_warmup_steps',
        'weight_decay': 'weight_decay',
        'grad_clip_norm': 'grad_clip_norm',
        'grad_accum_steps': 'grad_accum_steps',
        'grad_allreduce_dtype': 'grad_allreduce_dtype',
        'host_chunk_steps': 'host_chunk_steps',
        'host_upload_dtype': 'host_upload_dtype',
        'device_chunk_steps': 'device_chunk_steps',
        'init_style': 'init_style',
        'keep_best': 'keep_best',
        'early_stop_patience': 'early_stop_patience',
        'keep_checkpoints': 'keep_checkpoints',
        'async_checkpoint': 'async_checkpoint',
        'init_from_checkpoint': 'init_from_checkpoint',
        'freeze_params': 'freeze_params',
        'augment_mirror': 'augment_mirror',
        'augment_noise_std': 'augment_noise_std',
        'mirror_lateral_axis': 'mirror_lateral_axis',
        'short': 'short', 'data_loading_workers': 'data_loading_workers',
        'predict_grf_components': 'predict_grf_components',
        'predict_cop_components': 'predict_cop_components',
        'predict_moment_components': 'predict_moment_components',
        'predict_wrench_components': 'predict_wrench_components',
        'trial_filter': 'trial_filter', 'compute_report': 'compute_report',
        'aux_tau_weight': 'aux_tau_weight',
        'aux_com_acc_weight': 'aux_com_acc_weight',
        'aux_contact_weight': 'aux_contact_weight',
        'd_model': 'd_model', 'num_layers': 'num_layers',
        'num_heads': 'num_heads', 'attn_impl': 'attn_impl',
        'fused_inference': 'fused_inference', 'conv_impl': 'conv_impl',
        'diffusion_timesteps': 'diffusion_timesteps',
        'ema_decay': 'ema_decay',
        'cond_dropout': 'cond_dropout',
        'guidance_scale': 'guidance_scale',
        'model_parallel': 'model_parallel',
        'pipeline_parallel': 'pipeline_parallel',
        'pipeline_microbatches': 'pipeline_microbatches',
        'profile': 'profile', 'profile_dir': 'profile_dir',
        'device_data': 'device_data',
        'device_data_max_bytes': 'device_data_max_bytes',
        'pack_windows': 'pack_windows',
        'materialize_features': 'materialize_features',
    }
    for cfg_field, arg_name in mapping.items():
        if hasattr(args, arg_name):
            setattr(cfg, cfg_field, getattr(args, arg_name))
    return cfg
