#!/usr/bin/env bash
# Dataset preparation pipeline, PyTorch port.
#
# Capability parity: update_dataset.sh at the repo root (the reference's
# update_dataset.sh) — `addb` download of the standardized rajagopal_no_arms
# b3ds, post-processing (CoP/acc cleanup, 100 Hz resample,
# --root-history-len 10 --root-history-stride 3, --allowed-contact-bodies
# calcn_l calcn_r), then create-splits.
#
# When the `addb` CLI + network are available, the first block runs the real
# pipeline and converts to B3D-TPU; otherwise (air-gapped dev/test) the
# fallback generates a synthetic dataset with the same layout, through the
# port's writer (the same files the JAX package's writer makes), so every
# downstream command is exercisable. Run from the repo root (or with the
# repo on PYTHONPATH).
set -euo pipefail

DATA="${DATA:-../data}"
mkdir -p "$DATA/processed"

if command -v addb >/dev/null 2>&1; then
  echo "== downloading standardized dataset via addb =="
  pushd "$DATA" >/dev/null
  addb download "standardized/rajagopal_no_arms/**/*.b3d"
  addb post-process \
    --clean-up-noise --sample-rate 100 \
    --root-history-len 10 --root-history-stride 3 \
    --allowed-contact-bodies calcn_l calcn_r \
    standardized processed
  popd >/dev/null
  echo "NOTE: convert nimble .b3d -> B3D-TPU with SubjectOnDisk.from_nimble"
else
  echo "== addb unavailable: generating synthetic dataset =="
  python - "$DATA" <<'PYEOF'
import os, sys
from inferbiomechanics_tpu_torch.data.synthetic import write_synthetic_subject
data = sys.argv[1]
for ds_name, n_sub in [('synthA', 4), ('synthB', 3)]:
    for i in range(n_sub):
        d = os.path.join(data, 'processed', ds_name, f'subject{i}')
        os.makedirs(d, exist_ok=True)
        write_synthetic_subject(os.path.join(d, f'subject{i}.b3d'),
                                num_trials=3, trial_length=2000,
                                mass_kg=55 + 7 * i, seed=hash((ds_name, i)) % 2**31,
                                missing_frac=0.02)
        print(f'wrote {ds_name}/subject{i}')
PYEOF
fi

python -m inferbiomechanics_tpu_torch create-splits --data-path "$DATA"
echo "done: $DATA/train, $DATA/dev"
