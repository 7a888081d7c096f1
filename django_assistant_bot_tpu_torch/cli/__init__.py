"""Command line of the port: ``python -m django_assistant_bot_tpu_torch.cli serve|ann ...``."""

import argparse
from typing import Optional, Sequence

from . import ann, serve


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m django_assistant_bot_tpu_torch.cli")
    sub = parser.add_subparsers(dest="command", required=True)
    serve.add_parser(sub)
    ann.add_parser(sub)
    args = parser.parse_args(argv)
    return args.func(args)
