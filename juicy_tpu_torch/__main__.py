"""``python -m juicy_tpu_torch``: the CLI (cli.py)."""

from juicy_tpu_torch.cli import main

if __name__ == "__main__":
    main()
