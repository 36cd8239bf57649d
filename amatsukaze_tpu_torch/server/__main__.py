"""`python -m amatsukaze_tpu_torch.server` — headless server host (see
cli.py). The port's copy of amatsukaze_tpu/server/__main__.py, with the
host started under the __main__ check, so that importing the module (as
the package's import tests do) starts nothing."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
