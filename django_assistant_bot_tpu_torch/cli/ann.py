"""``ann``: train and inspect the IVF-PQ index, and operate its durable
directory (port of the JAX package's ``cli/ann.py``).

    python -m django_assistant_bot_tpu_torch.cli ann train --synthetic N --dim 768
    python -m django_assistant_bot_tpu_torch.cli ann stats --synthetic N
    python -m django_assistant_bot_tpu_torch.cli ann probe-recall --synthetic N --curve
    python -m django_assistant_bot_tpu_torch.cli ann snapshot --dir DIR --dim D
    python -m django_assistant_bot_tpu_torch.cli ann restore --dir DIR --dim D
    python -m django_assistant_bot_tpu_torch.cli ann verify --dir DIR

``--synthetic N`` indexes a seeded clustered corpus of N rows (the generator
the tests use, so recall numbers line up).  A knowledge-plane corpus
(``--model questions|sentences`` without ``--synthetic``) needs the ORM,
which waits for ROADMAP Queue 1 item 16, and is refused.  The durable
actions work on a WAL + snapshot directory (:mod:`..storage.durable`):
``--dir``, or ``$DABT_ANN_DURABLE_DIR/<Model>.<field>``, with ``--dim`` the
vector width.  ``verify`` is read-only and exits 1 on any digest or CRC
mismatch.  ``--device`` (default ``cuda``) places the index; without a card,
``cuda`` fails instead of falling back to the CPU.
"""

from __future__ import annotations

import json
import time

_MODEL_NAMES = {"questions": "Question", "sentences": "Sentence"}


def add_parser(sub):
    p = sub.add_parser("ann", help="train/inspect the IVF-PQ ANN index")
    p.add_argument(
        "action",
        choices=("train", "stats", "probe-recall", "snapshot", "restore", "verify"),
    )
    p.add_argument(
        "--dir", default=None,
        help="durable WAL+snapshot directory (default: settings ANN_DURABLE_DIR "
        "joined with <Model>.<field>); --dim gives the vector dim",
    )
    p.add_argument(
        "--model", choices=("questions", "sentences"), default="questions",
        help="knowledge-plane corpus (needs the ORM: ROADMAP Queue 1 item 16)",
    )
    p.add_argument("--field", default="embedding")
    p.add_argument(
        "--synthetic", type=int, default=0, metavar="N",
        help="index a seeded synthetic clustered corpus of N rows",
    )
    p.add_argument("--dim", type=int, default=256, help="vector dim")
    p.add_argument("--nlist", type=int, default=0, help="IVF lists (0 = auto)")
    p.add_argument("--m", type=int, default=0, help="PQ subquantizers (0 = auto)")
    p.add_argument("--nprobe", type=int, default=0, help="lists probed (0 = auto)")
    p.add_argument("--iters", type=int, default=4, help="k-means epochs at train")
    p.add_argument("--k", type=int, default=10, help="probe-recall: recall@k")
    p.add_argument("--queries", type=int, default=64, help="probe-recall: query count")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--curve", action="store_true",
        help="probe-recall: sweep nprobe in 1,2,4,... up to nlist",
    )
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.set_defaults(func=run)
    return p


def _build(args):
    from ..storage.ann import ANNIndex, make_clustered

    if not args.synthetic:
        raise SystemExit(
            f"ann {args.action}: indexing --model {args.model} needs the ORM, which waits "
            "for ROADMAP Queue 1 item 16; use --synthetic N"
        )
    t0 = time.perf_counter()
    rows = make_clustered(args.synthetic, args.dim, seed=args.seed)
    index = ANNIndex(args.dim, nlist=args.nlist, m=args.m, nprobe=args.nprobe, seed=args.seed,
                     device=args.device)
    index.add(range(args.synthetic), rows)
    index.train(nlist=args.nlist, iters=args.iters, seed=args.seed)
    return index, time.perf_counter() - t0


def _durable_target(args):
    """(directory, dim) for the durable actions: explicit --dir, or the
    settings-derived per-corpus directory; --dim gives the dim."""
    import os

    from ..conf import settings

    if args.dir:
        return args.dir, args.dim
    base = settings.ANN_DURABLE_DIR
    if not base:
        raise SystemExit("ann: no --dir and DABT_ANN_DURABLE_DIR is unset — nothing to target")
    return os.path.join(base, f"{_MODEL_NAMES[args.model]}.{args.field}"), args.dim


def _run_durable(args) -> int:
    from ..storage.durable import DurableANN, verify_dir

    directory, dim = _durable_target(args)
    if args.action == "verify":
        report = verify_dir(directory)
        print(json.dumps(report, indent=2, sort_keys=True, default=str))
        return 0 if report["ok"] else 1

    # snapshot + restore both start with a recovery (latest valid snapshot +
    # WAL-tail replay) — restore stops there and reports; snapshot goes on to
    # commit a fresh snapshot and prune the replayed WAL tail behind it
    dur = DurableANN(directory, dim=dim, nlist=args.nlist, m=args.m, nprobe=args.nprobe,
                     seed=args.seed, device=args.device)
    try:
        if args.action == "snapshot":
            if not dur.writable:
                print(f"(another process holds the WAL lock on {directory})")
                return 1
            dur.snapshot()
        st = dur.durability_stats()
        st["rows"] = len(dur)
        st["retrain_advised"] = bool(dur.index.stats().get("retrain_advised"))
        print(json.dumps(st, indent=2, sort_keys=True, default=str))
    finally:
        dur.close()
    return 0


def run(args) -> int:
    if args.action in ("snapshot", "restore", "verify"):
        return _run_durable(args)
    index, build_s = _build(args)
    if not len(index):
        print("(corpus empty — nothing to index)")
        return 1

    if args.action == "probe-recall":
        probes = [None]
        if args.curve:
            probes, p = [], 1
            while p < index.nlist:
                probes.append(p)
                p *= 2
            probes.append(index.nlist)
        for nprobe in probes:
            t0 = time.perf_counter()
            r = index.probe_recall(n_queries=args.queries, k=args.k, nprobe=nprobe, seed=args.seed)
            ms = (time.perf_counter() - t0) * 1000 / max(1, args.queries)
            print(
                f"nprobe={r['nprobe']:5d}  recall@{r['k']}={r['recall_at_k']:.4f}  "
                f"{ms:8.3f} ms/query"
            )
        return 0

    # train and stats both end in the snapshot; train adds the build time
    st = index.stats()
    if args.action == "train":
        st["build_s"] = round(build_s, 3)
        st["restage_s"] = {k: round(v, 3) for k, v in index.last_restage.items()}
    print(json.dumps(st, indent=2, sort_keys=True, default=str))
    return 0
