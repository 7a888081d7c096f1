"""``serve``: run the HTTP server over a model registry.

    python -m django_assistant_bot_tpu_torch.cli serve --tiny|--config FILE \\
        [--host H] [--port N] [--device cuda|cpu]

``--tiny`` serves a random-weights tiny encoder as ``tiny-emb`` and a tiny
decoder as ``tiny-chat``, both with the byte tokenizer.  ``--device``
(default ``cuda``) places every model; without
a card, ``cuda`` fails instead of falling back to the CPU.
"""

from __future__ import annotations

import logging


def add_parser(sub):
    p = sub.add_parser("serve", help="serve /embeddings/ and /dialog/ over HTTP")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--config", help="TOML/JSON model config file")
    src.add_argument("--tiny", action="store_true", help="serve tiny random models")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=11435)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.set_defaults(func=run)
    return p


def run(args) -> int:
    from ..serving.registry import ModelRegistry
    from ..serving.server import load_config_file, run_server

    logging.basicConfig(level=logging.INFO)
    if args.tiny:
        config = {
            "tiny-emb": {"kind": "encoder", "tiny": True, "normalize": False},
            "tiny-chat": {"kind": "decoder", "tiny": True, "max_slots": 4, "max_seq_len": 256},
        }
    else:
        config = load_config_file(args.config)
    registry = ModelRegistry.from_config(config, device=args.device)
    run_server(registry, host=args.host, port=args.port)
    return 0
