"""Run-config sidecar: a ``run_config.json`` written next to checkpoints.

The port's own copy of ``inferbiomechanics_tpu/train/run_config.py`` (which
imports no JAX; ``tests/test_torch_train.py`` holds the two together).

The reference saves bare ``state_dict`` files (train.py:270-278 — only
tensors), so every consumer (analyze.py:31-47, the visualizers) must
re-specify the architecture flags by hand, and a mismatch surfaces as
an opaque ``size mismatch`` load error. Here training drops one JSON
sidecar per checkpoint dir recording the full config, and consumers
use it to (a) auto-configure auxiliary models — the partial-denoise
proposal (`models/diffusion.py make_partial_proposal_fn`) rebuilds
itself from the sidecar so ``--init-checkpoint`` needs no architecture
re-spelling — and (b) warn, field by field, when CLI flags disagree
with what the checkpoints were trained as (the root cause behind shape
errors at load time).

The sidecar is advisory: every path works without one (dirs produced
by older runs or by ``convert-checkpoint``), and explicit CLI flags
always win for the MAIN model — only warnings are emitted.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Dict, List, Optional

from inferbiomechanics_tpu_torch.config import Config

logger = logging.getLogger(__name__)

RUN_CONFIG_NAME = 'run_config.json'
SCHEMA_VERSION = 1

# Fields that determine the parameter-tree SHAPE of a checkpoint (what
# build_model_for_dataset consumes). Data/optimizer/runtime knobs are
# recorded in the sidecar too, but only these participate in
# architecture auto-fill and mismatch warnings.
ARCHITECTURE_FIELDS = (
    'model_type', 'output_data_format', 'window_size', 'stride',
    'hidden_dims', 'activation', 'init_style', 'dropout', 'dropout_prob',
    'batchnorm', 'd_model', 'num_layers', 'num_heads', 'attn_impl',
    'conv_impl', 'diffusion_timesteps',
)

# The subset whose drift changes the parameter layout or window
# geometry. Resuming training across one of these is NEVER right: the
# checkpoint no longer fits the model the flags describe. (The remaining
# ARCHITECTURE_FIELDS are
# legitimately overridable mid-run: conv_impl/attn-serving swaps share
# param layout, init_style/activation/dropout knobs carry no params.)
SHAPE_CRITICAL_FIELDS = (
    'model_type', 'output_data_format', 'window_size', 'stride',
    'hidden_dims', 'batchnorm', 'd_model', 'num_layers', 'num_heads',
    'attn_impl',   # vpu/flax/pallas store different param trees
)


def save_run_config(checkpoint_dir: str, config: Config) -> Optional[str]:
    """Write ``run_config.json`` into ``checkpoint_dir`` (atomic rename).

    Multi-process safe the same way checkpoints are: callers gate on
    process 0. Returns the path, or None if the write failed (the
    sidecar is provenance, never worth failing a training run over)."""
    payload = dataclasses.asdict(config)
    payload['schema_version'] = SCHEMA_VERSION
    # which space models/diffusion.py trains denoisers in under THIS
    # code version; checkpoint_target_space reads it back so samplers
    # don't denormalize legacy raw-space checkpoints (key absent = raw)
    payload['diffusion_target_space'] = 'normalized'
    path = os.path.join(checkpoint_dir, RUN_CONFIG_NAME)
    try:
        os.makedirs(checkpoint_dir, exist_ok=True)
        tmp = path + '.tmp'
        with open(tmp, 'w') as f:
            json.dump(payload, f, indent=1, sort_keys=True, default=str)
        os.replace(tmp, path)
        return path
    except OSError as e:
        logger.warning('could not write %s: %s', path, e)
        return None


def save_partial_run_config(checkpoint_dir: str,
                            fields: Dict) -> Optional[str]:
    """Write a sidecar carrying only the given architecture fields —
    used by convert-checkpoint, which can INFER some fields from a
    torch state dict (model family, hidden dims, batchnorm) but not
    others (activation, window geometry). Consumers treat missing
    fields as unknown: no warning, no auto-fill."""
    payload = {k: v for k, v in fields.items() if v is not None}
    payload['schema_version'] = SCHEMA_VERSION
    payload['partial'] = True
    path = os.path.join(checkpoint_dir, RUN_CONFIG_NAME)
    try:
        os.makedirs(checkpoint_dir, exist_ok=True)
        tmp = path + '.tmp'
        with open(tmp, 'w') as f:
            json.dump(payload, f, indent=1, sort_keys=True, default=str)
        os.replace(tmp, path)
        return path
    except OSError as e:
        logger.warning('could not write %s: %s', path, e)
        return None


def load_run_config(checkpoint_dir: str) -> Optional[Dict]:
    """Read the sidecar from a checkpoint dir (or a checkpoint FILE's
    dir). Returns None when absent; warns and returns None when
    unreadable/corrupt."""
    d = checkpoint_dir
    if d.endswith(('.ckpt', '.pt')) or os.path.isfile(d):
        d = os.path.dirname(d)
    path = os.path.join(d, RUN_CONFIG_NAME)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError) as e:
        logger.warning('unreadable run-config sidecar %s: %s', path, e)
        return None
    if not isinstance(payload, dict):
        logger.warning('malformed run-config sidecar %s (not an object)',
                       path)
        return None
    return payload


def apply_architecture(config: Config, sidecar: Dict) -> Config:
    """Return ``config`` with every ARCHITECTURE_FIELD present in the
    sidecar replaced by the sidecar's value (the checkpoint knows its
    own shape better than CLI defaults do)."""
    updates = {}
    for f in ARCHITECTURE_FIELDS:
        if f in sidecar and sidecar[f] is not None:
            updates[f] = sidecar[f]
    if 'hidden_dims' in updates:
        updates['hidden_dims'] = [int(h) for h in updates['hidden_dims']]
    return dataclasses.replace(config, **updates)


def architecture_mismatches(config: Config, sidecar: Dict) -> List[str]:
    """Human-readable ``field: cli=X, checkpoint=Y`` lines for every
    architecture field where the CLI config disagrees with the sidecar."""
    out = []
    for f in ARCHITECTURE_FIELDS:
        if f not in sidecar:
            continue
        have, want = getattr(config, f), sidecar[f]
        if f == 'hidden_dims':
            have, want = [int(h) for h in have], [int(h) for h in want]
        if have != want:
            out.append(f'{f}: cli={have!r}, checkpoint={want!r}')
    return out


def add_run_config_flag(parser) -> None:
    """Register ``--use-run-config`` on a consumer subcommand."""
    parser.add_argument(
        '--use-run-config', action='store_true',
        help='Take the model architecture from the checkpoint dir\'s '
             'run_config.json (written by every training run) instead '
             'of spelling --hidden-dims/--activation/... by hand; '
             'explicit architecture flags are overridden')


def use_run_config_if_requested(config: Config, args) -> Config:
    """CLI hook for ``--use-run-config``: replace the config's
    architecture fields with the checkpoint dir's sidecar values.
    ``{checkpoint_dir}/{model_type}`` must hold a run_config.json (every
    training run writes one); explicit architecture flags are
    OVERRIDDEN — the point of the flag is to not spell them."""
    if not getattr(args, 'use_run_config', False):
        return config
    d = os.path.join(os.path.abspath(config.checkpoint_dir),
                     config.model_type)
    sidecar = load_run_config(d)
    if sidecar is None:
        raise SystemExit(
            f'--use-run-config: no {RUN_CONFIG_NAME} in {d} (written by '
            'every training run; older dirs and convert-checkpoint '
            'output need the architecture flags spelled out)')
    cfg = apply_architecture(config, sidecar)
    changed = architecture_mismatches(config, sidecar)
    if changed:
        logger.info('--use-run-config %s: %s', d, '; '.join(changed))
    if sidecar.get('partial'):
        logger.info('--use-run-config: %s is a partial sidecar (inferred '
                    'by convert-checkpoint) — fields it does not record '
                    '(e.g. window geometry, activation) still come from '
                    'your flags', d)
    return cfg


def check_resume_architecture(config: Config, checkpoint_dir: str) -> None:
    """Hard gate for train-resume: raise when the current flags drift
    from the previous run's sidecar on a SHAPE_CRITICAL_FIELDS field
    (see that constant for why a drifted resume is silent, not a
    crash). Non-critical drift still warns via the caller."""
    sidecar = load_run_config(checkpoint_dir)
    if sidecar is None:
        return
    bad = []
    for f in SHAPE_CRITICAL_FIELDS:
        if f not in sidecar:
            continue
        have, want = getattr(config, f), sidecar[f]
        if f == 'hidden_dims':
            have, want = [int(h) for h in have], [int(h) for h in want]
        if have != want:
            bad.append(f'{f}: cli={have!r}, checkpoint={want!r}')
    if bad:
        raise ValueError(
            f'cannot resume in {checkpoint_dir}: these flags change the '
            'parameter layout or window geometry, so the run would '
            'silently keep the checkpoint\'s old architecture —\n  '
            + '\n  '.join(bad)
            + '\nEither drop the conflicting flags (the previous run\'s '
            'run_config.json records the trained values), or point '
            '--checkpoint-dir at a fresh directory for the new '
            'architecture.')


def warn_on_architecture_mismatch(config: Config, checkpoint_dir: str,
                                  context: str = '') -> List[str]:
    """Load the sidecar (if any) and WARN about CLI/checkpoint
    architecture disagreements. Returns the mismatch lines (empty when
    clean or no sidecar). Advisory only — explicit flags may be an
    intentional override (e.g. --conv-impl swaps, --attn-impl serving),
    and several architecture fields don't change the param tree."""
    sidecar = load_run_config(checkpoint_dir)
    if sidecar is None:
        return []
    lines = architecture_mismatches(config, sidecar)
    if lines:
        logger.warning(
            'config does not match what %s was trained as%s — if loading '
            'fails with a shape error, drop the conflicting flags (the '
            'checkpoint dir records its own architecture):\n  %s',
            checkpoint_dir, f' ({context})' if context else '',
            '\n  '.join(lines))
    return lines
