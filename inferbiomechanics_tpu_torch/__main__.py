"""``python -m inferbiomechanics_tpu_torch {serve,train,analyze,convert-checkpoint,sweep,export,
save-prediction-csv,visualize-file,review-file,visualize,pickle-data,create-splits,
sanity-check} ...``"""

import argparse
import logging
from typing import Optional, Sequence

from inferbiomechanics_tpu_torch.cli import (
    analyze_cmd, convert_checkpoint_cmd, create_splits_cmd, export_cmd, pickle_data_cmd,
    review_file_cmd, sanity_check_cmd, save_prediction_csv_cmd, serve_cmd, sweep_cmd, train_cmd,
    visualize_cmd, visualize_file_cmd,
)

COMMANDS = {'serve': serve_cmd, 'train': train_cmd, 'analyze': analyze_cmd,
            'convert-checkpoint': convert_checkpoint_cmd, 'sweep': sweep_cmd,
            'export': export_cmd, 'save-prediction-csv': save_prediction_csv_cmd,
            'visualize-file': visualize_file_cmd, 'review-file': review_file_cmd,
            'visualize': visualize_cmd, 'pickle-data': pickle_data_cmd,
            'create-splits': create_splits_cmd, 'sanity-check': sanity_check_cmd}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog='python -m inferbiomechanics_tpu_torch')
    sub = parser.add_subparsers(dest='command', required=True)
    for module in COMMANDS.values():
        module.register_subcommand(sub)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(levelname)s %(name)s: %(message)s')
    args = build_parser().parse_args(argv)
    return COMMANDS[args.command].run(args)


if __name__ == '__main__':
    raise SystemExit(main())
