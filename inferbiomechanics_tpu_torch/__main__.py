"""``python -m inferbiomechanics_tpu_torch serve ...``"""

from inferbiomechanics_tpu_torch.cli.serve_cmd import main

if __name__ == '__main__':
    raise SystemExit(main())
