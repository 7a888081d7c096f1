"""Model registry: spec -> loaded engine (port of ``serving/registry.py``).

A config maps model names to spec dicts, as in the JAX package.
``kind="decoder"`` loads a :class:`~.engine.GenerationEngine`,
``kind="encoder"`` an :class:`~.engine.EmbeddingEngine`.  The spec carries
the fields the port implements, with the JAX spec's defaults (prefix
sharing, the observability plane and crash-only supervision included).  An
encoder spec that sets a decoder-only knob is refused, as the JAX registry
refuses it.  ``quantize`` ("int8" / "int4", with ``quant_group_size``)
quantizes a decoder's layer projections on the host before placement, as
the JAX registry does (a MoE decoder's is refused: ROADMAP Queue 1 item 17);
``num_experts`` makes a ``tiny`` decoder a Mixtral MoE, and a ``path`` serves
a Mixtral checkpoint; ``warmup`` / ``warmup_json`` run the engine's
``warmup`` before it starts; ``speculative`` / ``spec_width`` serve
tree-verified speculative decoding, refused on an encoder and with
``warmup_json`` as in JAX; ``kv_cache_dtype`` ("bf16", "fp8", "fp8_e5m2")
sets the page pool's precision and ``attn_fp8`` the fp8 in-dot decode,
checked with the JAX registry's messages.  Keys of the JAX ``ModelSpec`` that are not ported yet are
accepted only at the value the port implements and refused otherwise,
naming their ROADMAP item; keys the JAX spec does not know are refused too.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Mapping, Optional

import torch


logger = logging.getLogger(__name__)

# JAX ModelSpec keys not ported yet: key -> (the only accepted value, ROADMAP item)
_DEFERRED: Dict[str, tuple] = {
    "checkpoint": (None, "Queue 1 item 4 (native checkpoints)"),
    "kv_host_bytes": (0, "Queue 1 item 12 (tiered KV)"),
    "kv_spill_dir": (None, "Queue 1 item 12 (tiered KV)"),
    "replicas": (1, "Queue 1 item 12 (router)"),
    "max_replicas": (0, "Queue 1 item 12 (router)"),
    "autoscale": (False, "Queue 1 item 12 (autoscaler)"),
    "pool": ("unified", "Queue 1 item 13 (cross-host fleet)"),
    "replica_devices": (0, "Queue 1 item 15 (parallelism)"),
}
_ABSENT = object()  # knobs of unported features: refused whenever present
# JAX ModelSpec key prefixes / names of unported features -> ROADMAP item
_DEFERRED_FAMILIES = (
    (("kv_host_writethrough", "router_", "autoscale_"), "Queue 1 item 12 (tiered KV, router, autoscaler)"),
)
# decoder-only knobs the JAX registry refuses on an encoder: key -> test of
# a value that sets it (the JAX checks' own truthiness)
_DECODER_ONLY = {
    "quantize": bool,
    "decode_steps": bool,
    "warmup_json": bool,
    "speculative": bool,
    "kv_cache_dtype": lambda v: v is not None,
    "attn_fp8": bool,
    "kv_host_bytes": bool,
    "kv_spill_dir": bool,
    "replicas": lambda v: v > 1,
    "max_replicas": bool,
    "autoscale": bool,
    "replica_devices": bool,
    "pool": lambda v: v != "unified",
}
_KINDS = ("decoder", "encoder")
_QUANT_BITS = {"int8": 8, "int4": 4}


def _check_speculative(spec: "ModelSpec") -> None:
    """The JAX registry's speculative checks and messages (the card's tree
    kernel takes a tree of any size, as the JAX engine does)."""
    name = spec.name.lower()
    if spec.speculative and spec.kind == "encoder":
        raise ValueError(f"model {name}: speculative is decoder-only")
    if spec.speculative and spec.warmup_json:
        raise ValueError(
            f"model {name}: speculative excludes JSON-constrained decoding "
            "(the token FSM is sequential); use a separate model entry"
        )


def _check_kv_cache(spec: "ModelSpec") -> None:
    """The JAX registry's ``kv_cache_dtype`` / ``attn_fp8`` checks, with its
    messages."""
    from ..ops.quant import KV_CACHE_DTYPES

    name = spec.name.lower()
    if spec.kv_cache_dtype is not None and spec.kind == "encoder":
        raise ValueError(
            f"model {name}: kv_cache_dtype is decoder-only (encoders have no KV cache)"
        )
    if spec.kv_cache_dtype not in KV_CACHE_DTYPES:
        raise ValueError(
            f"model {name}: unknown kv_cache_dtype={spec.kv_cache_dtype!r}; "
            f"expected one of {sorted(k for k in KV_CACHE_DTYPES if k)}"
        )
    if spec.attn_fp8 and spec.kind == "encoder":
        raise ValueError(f"model {name}: attn_fp8 is decoder-only")
    if spec.attn_fp8 and spec.kv_cache_dtype not in ("fp8", "fp8_e5m2"):
        raise ValueError(
            f"model {name}: attn_fp8 requires an fp8 KV cache "
            f"(kv_cache_dtype='fp8' or 'fp8_e5m2', got {spec.kv_cache_dtype!r}) — the "
            "in-dot scheme consumes the stored fp8 operand directly"
        )


def _check_quantize(spec: "ModelSpec") -> None:
    """The JAX registry's quantization checks, with its messages."""
    name = spec.name.lower()
    if spec.quantize and spec.kind == "encoder":
        raise ValueError(
            f"model {name}: quantize={spec.quantize!r} is decoder-only "
            "(encoders are compute-bound, not weight-read-bound)"
        )
    if spec.quantize and spec.quantize not in _QUANT_BITS:
        raise ValueError(f"model {name}: unknown quantize={spec.quantize!r}")
    if spec.quantize and spec.num_experts:
        _refuse_quantized_moe(name, spec.quantize)
    if spec.quant_group_size < 2 or spec.quant_group_size % 2:
        raise ValueError(
            f"model {name}: quant_group_size must be an even int >= 2 "
            f"(got {spec.quant_group_size})"
        )


def _refuse_quantized_moe(name: str, quantize: str) -> None:
    from ..models.mixtral import QUANTIZED_EXPERTS

    raise ValueError(f"model {name}: quantize={quantize!r} with a MoE decoder is not ported "
                     f"yet; {QUANTIZED_EXPERTS}")


def _apply_quantize(spec: "ModelSpec", params: Dict[str, Any]) -> Dict[str, Any]:
    """``spec.quantize`` on dense params: quantize every layer projection on
    the host, one leaf (and one layer) at a time.  Params that are already
    quantized follow the JAX rules: the same format is a no-op (a warning
    when the spec's int4 group size differs from theirs), another one is a
    configuration error."""
    from ..ops.quant import QTensor4, quantize_decoder_params, weight_bits

    name = spec.name.lower()
    bits, want = weight_bits(params), _QUANT_BITS[spec.quantize]
    if bits == 16:
        return quantize_decoder_params(params, fmt=spec.quantize, group_size=spec.quant_group_size)
    if bits != want:
        raise ValueError(
            f"model {name}: checkpoint is already quantized (int{bits}) but the spec asks for "
            f"quantize={spec.quantize!r}; re-convert the checkpoint in the desired format or "
            "drop the knob"
        )
    logger.info("model %s: checkpoint is already %s-quantized; quantize=%r is a no-op",
                name, spec.quantize, spec.quantize)
    groups = {w.group_size for w in params["layers"].values() if isinstance(w, QTensor4)}
    if groups and groups != {spec.quant_group_size}:
        logger.warning("model %s: quant_group_size=%d has no effect: the checkpoint was packed "
                       "at group size(s) %s; re-convert to change it",
                       name, spec.quant_group_size, sorted(groups))
    return params


def _params_to(params: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """Every leaf (tensor or quantized weight) moved to ``device``."""
    return {k: _params_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in params.items()}


def _deferred(key: str):
    if key in _DEFERRED:
        return _DEFERRED[key]
    for names, item in _DEFERRED_FAMILIES:
        if any(key == n or (n.endswith("_") and key.startswith(n)) for n in names):
            return _ABSENT, item
    return None

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class ModelSpec:
    name: str
    kind: str = "decoder"  # "decoder" | "encoder"
    path: Optional[str] = None  # HF checkpoint dir; None + tiny=True -> random tiny
    tiny: bool = False
    dtype: str = "bfloat16"
    device: str = "cuda"
    # weight-only quantization of the layer projections: None, "int8" (per
    # output channel) or "int4" (per quant_group_size rows and channel)
    quantize: Optional[str] = None
    quant_group_size: int = 64
    # Mixtral MoE on a random tiny decoder (``tiny``): experts per layer, 0 =
    # dense (a ``path`` checkpoint brings its own from its config)
    num_experts: int = 0
    max_slots: int = 8
    max_seq_len: Optional[int] = None
    chunk_size: int = 512
    lookahead: int = 3
    # fused decode tick depth: 0 inherits ``burst`` (the JAX resolution)
    burst: int = 8
    decode_steps: int = 0
    prefill_piggyback: bool = True
    decode_kv_chunk: Optional[int] = 0
    # "paged" (a page pool with block tables) or "legacy" (the contiguous
    # [max_slots, max_seq_len] slot cache, read by the chunked decode)
    kv_layout: str = "paged"
    kv_page_size: int = 0
    kv_pages: int = 0
    # the page pool's precision: None (the model's dtype), "bf16", "fp8"
    # (e4m3) or "fp8_e5m2"; fp8 halves the KV bytes (lossy, opt-in)
    kv_cache_dtype: Optional[str] = None
    # fp8 in-dot decode attention: the query quantized to the pool's fp8
    # format, both products on fp8 values (needs an fp8 kv_cache_dtype)
    attn_fp8: bool = False
    # tree-verified prompt-lookup speculative decoding: up to `spec_width`
    # distinct continuations of depth `speculative` verified a tick (0 = off)
    speculative: int = 0
    spec_width: int = 4
    # admission-controlled scheduling (serving/scheduler.py); False keeps the
    # unbounded FIFO.  The sched_* knobs are the JAX spec's, same defaults.
    scheduler: bool = True
    sched_max_queue: int = 256
    sched_class_weights: Optional[Mapping[str, float]] = None
    sched_tenant_weights: Optional[Mapping[str, float]] = None
    sched_admit_max_wait_s: Optional[float] = 60.0
    sched_default_deadline_s: Optional[float] = None
    sched_degrade_at: float = 0.75
    sched_degrade_max_tokens: int = 256
    # prefix sharing (serving/kv_pool.py): registry entries for shared
    # prompt prefixes (system + RAG context), the shortest prefix worth one,
    # and the registry's byte budget; 0 entries disables it
    prefix_cache: int = 8
    prefix_min_tokens: int = 32
    prefix_cache_max_bytes: int = 1 << 30
    # resilience (serving/faults.py + engine supervision): fault injection
    # (site -> probability or schedule; None also honours DABT_FAULTS, {}
    # forces it off), the restart circuit, backoff between restarts, the
    # heartbeat age that flips /healthz, and restarts one request may ride
    faults: Optional[Mapping[str, Any]] = None
    fault_seed: int = 0
    max_restarts: int = 5
    restart_window_s: float = 60.0
    restart_backoff_s: float = 0.05
    restart_backoff_max_s: float = 2.0
    degraded_cooldown_s: float = 30.0
    heartbeat_degraded_s: float = 30.0
    max_request_restarts: int = 2
    # observability (serving/obs.py): traces, /metrics histograms, flight
    # recorder (dump directory None = DABT_FLIGHT_DIR, else <tmpdir>)
    obs: bool = True
    obs_dump_dir: Optional[str] = None
    # encoders: the coalescer's batch bound, unit-norm output, and the queue
    # bound past which /embeddings/ sheds with 429
    max_batch: int = 64
    normalize: bool = False
    max_queue: int = 1024
    # run the engine's warmup() before start (a decoder's with json=True
    # when warmup_json, which implies it)
    warmup: bool = False
    warmup_json: bool = False

    @classmethod
    def from_dict(cls, name: str, d: Mapping[str, Any]) -> "ModelSpec":
        fields = {f.name for f in dataclasses.fields(cls)}
        d = dict(d)
        # the JAX spec's deprecation shim: the old prefix-LRU knob name maps
        # onto the page registry ("prefix_cache" wins when both are given)
        if "prefix_cache_size" in d:
            val = d.pop("prefix_cache_size")
            if "prefix_cache" not in d:
                logger.warning("model %s: 'prefix_cache_size' is deprecated; mapped onto "
                               "'prefix_cache'", name)
                d["prefix_cache"] = val
        kwargs = {}
        if d.get("kind", "decoder") not in _KINDS:
            raise ValueError(f"model {name}: kind must be one of {list(_KINDS)}")
        for key, value in d.items():
            if key == "name":
                continue
            if d.get("kind") == "encoder" and key in _DECODER_ONLY and _DECODER_ONLY[key](value):
                if key == "quantize":
                    _check_quantize(cls(name=name, kind="encoder", quantize=value))
                raise ValueError(f"model {name}: {key} is decoder-only")
            deferred = _deferred(key)
            if deferred is not None:
                ported, item = deferred
                if ported is _ABSENT or value != ported:
                    only = "" if ported is _ABSENT else f" (only {ported!r})"
                    raise NotImplementedError(
                        f"model {name}: {key}={value!r} is not ported yet{only}; ROADMAP {item}"
                    )
                continue
            if key not in fields:
                raise ValueError(f"model {name}: unknown spec key {key!r}")
            kwargs[key] = value
        spec = cls(name=name, **kwargs)
        _check_quantize(spec)
        _check_speculative(spec)
        _check_kv_cache(spec)
        if spec.dtype not in _DTYPES:
            raise ValueError(f"model {name}: dtype must be one of {sorted(_DTYPES)}")
        if spec.decode_steps < 0:
            raise ValueError(
                f"model {name}: decode_steps must be >= 1 (or 0 = inherit "
                f"burst); got {spec.decode_steps}"
            )
        return spec

    def build_scheduler(self):
        """The spec's :class:`~.scheduler.RequestScheduler`, or None."""
        if not self.scheduler:
            return None
        from .scheduler import RequestScheduler, SchedulerConfig

        sched = RequestScheduler(
            SchedulerConfig.from_knobs(
                max_queue=self.sched_max_queue,
                class_weights=self.sched_class_weights,
                tenant_weights=self.sched_tenant_weights,
                degrade_at=self.sched_degrade_at,
                degrade_max_tokens=self.sched_degrade_max_tokens,
            )
        )
        # None means "off" for these two, so they bypass from_knobs' filter
        sched.cfg.admit_max_wait_s = self.sched_admit_max_wait_s
        sched.cfg.default_deadline_s = self.sched_default_deadline_s
        return sched

    def build_faults(self):
        """The spec's :class:`~.faults.FaultInjector`, or None: an explicit
        ``faults`` wins ({} forces injection off), else the ``DABT_FAULTS``
        environment variable applies."""
        from .faults import FaultInjector

        if self.faults is not None:
            return FaultInjector.from_spec(self.faults, seed=self.fault_seed)
        return FaultInjector.from_env()

    def engine_kwargs(self) -> Dict[str, Any]:
        """The engine knobs of this spec, as ``GenerationEngine`` keywords
        (a fresh scheduler and fault injector each call)."""
        return dict(
            max_slots=self.max_slots,
            max_seq_len=self.max_seq_len,
            chunk_size=self.chunk_size,
            lookahead=self.lookahead,
            burst=self.burst,
            decode_steps=self.decode_steps or None,
            prefill_piggyback=self.prefill_piggyback,
            decode_kv_chunk=self.decode_kv_chunk,
            kv_layout=self.kv_layout,
            kv_page_size=self.kv_page_size,
            kv_pages=self.kv_pages,
            kv_cache_dtype=self.kv_cache_dtype,
            attn_fp8=self.attn_fp8,
            speculative=self.speculative,
            spec_width=self.spec_width,
            prefix_cache_size=self.prefix_cache,
            prefix_min_tokens=self.prefix_min_tokens,
            prefix_cache_max_bytes=self.prefix_cache_max_bytes,
            scheduler=self.build_scheduler(),
            faults=self.build_faults(),
            max_restarts=self.max_restarts,
            restart_window_s=self.restart_window_s,
            restart_backoff_s=self.restart_backoff_s,
            restart_backoff_max_s=self.restart_backoff_max_s,
            degraded_cooldown_s=self.degraded_cooldown_s,
            heartbeat_degraded_s=self.heartbeat_degraded_s,
            max_request_restarts=self.max_request_restarts,
            name=self.name,
            obs=self.obs,
            obs_dump_dir=self.obs_dump_dir,
        )


class ModelRegistry:
    """Loads and owns generation and embedding engines; lookup is lowercase."""

    def __init__(self, specs: Optional[Mapping[str, ModelSpec]] = None):
        self.specs: Dict[str, ModelSpec] = {}
        self.embedders: Dict[str, Any] = {}
        self.generators: Dict[str, Any] = {}
        for spec in (specs or {}).values():
            self.load(spec)

    @classmethod
    def from_config(cls, config: Mapping[str, Any], *, device: Optional[str] = None) -> "ModelRegistry":
        """``config`` maps model name -> spec dict (parsed from TOML/JSON);
        ``device`` overrides every spec's device (the CLI's ``--device``)."""
        specs = {}
        for name, d in config.items():
            d = dict(d)
            if device is not None:
                d["device"] = device
            specs[name.lower()] = ModelSpec.from_dict(name.lower(), d)
        return cls(specs)

    def load(self, spec: ModelSpec, engine: Any = None) -> Any:
        """Build, start and register ``spec``'s engine: random tiny weights
        (``tiny``), an HF checkpoint (``path``), or ``engine`` built by the
        caller (started here if it is not running yet)."""
        from ..models import DecoderConfig, llama
        from ..models.hf_loader import load_decoder
        from .engine import GenerationEngine
        from .tokenizer import load_tokenizer

        name = spec.name.lower()
        _check_quantize(spec)
        _check_speculative(spec)
        _check_kv_cache(spec)
        if spec.kind == "encoder":
            return self._load_encoder(name, spec, engine)
        if engine is None:
            from ..device import resolve_device

            device = resolve_device(spec.device)
            dtype = _DTYPES[spec.dtype]
            if spec.path:
                # quantized on the host before placement: the card never
                # holds the stacked dense weights
                cfg, params = load_decoder(spec.path, dtype=dtype,
                                           device="cpu" if spec.quantize else device)
            elif spec.tiny:
                cfg = DecoderConfig.tiny(num_experts=spec.num_experts)
                if spec.max_seq_len and spec.max_seq_len > cfg.max_seq_len:
                    # a random tiny model has no pretrained context limit
                    cfg = dataclasses.replace(cfg, max_seq_len=int(spec.max_seq_len))
                gen = torch.Generator(device=device).manual_seed(0)
                params = llama.init(cfg, gen, device)
            else:
                raise ValueError(f"model {name}: need path or tiny=true")
            if spec.quantize:
                if cfg.is_moe:
                    _refuse_quantized_moe(name, spec.quantize)
                params = _params_to(_apply_quantize(spec, params), device)
            engine = GenerationEngine(
                cfg, params, load_tokenizer(spec.path), device=device, **spec.engine_kwargs()
            )
        if (spec.warmup or spec.warmup_json) and not engine._running:
            engine.warmup(json=spec.warmup_json)
        engine.start()
        self.generators[name] = engine
        self.specs[name] = spec
        logger.info("model %r ready on %s", name, engine.device)
        return engine

    def _load_encoder(self, name: str, spec: ModelSpec, engine: Any) -> Any:
        from ..models import EncoderConfig, encoder
        from ..models.hf_loader import load_encoder
        from .engine import EmbeddingEngine
        from .tokenizer import load_tokenizer

        if engine is None:
            from ..device import resolve_device

            device = resolve_device(spec.device)
            if spec.path:
                cfg, params = load_encoder(spec.path, dtype=_DTYPES[spec.dtype], device=device)
            elif spec.tiny:
                cfg = EncoderConfig.tiny()
                params = encoder.init(cfg, torch.Generator(device=device).manual_seed(0), device)
            else:
                raise ValueError(f"model {name}: need path or tiny=true")
            engine = EmbeddingEngine(
                cfg, params, load_tokenizer(spec.path), max_batch=spec.max_batch,
                normalize=spec.normalize, max_queue=spec.max_queue, device=device,
            )
        if spec.warmup and not engine._running:
            engine.warmup()
        engine.start()
        self.embedders[name] = engine
        self.specs[name] = spec
        logger.info("encoder %r ready on %s", name, engine.device)
        return engine

    def stop(self):
        for eng in self.embedders.values():
            eng.stop()
        for eng in self.generators.values():
            eng.stop()

    def get_embedder(self, model: str):
        return self.embedders.get(model.lower())

    def get_generator(self, model: str):
        return self.generators.get(model.lower())
