"""The port's boundaries: no JAX in its import graph, and CUDA by default
with no silent CPU fallback."""

import subprocess
import sys

import pytest
import torch

_IMPORT_ALL = """
import importlib, pkgutil, sys
import django_assistant_bot_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
assert "django_assistant_bot_tpu_torch.serving.scheduler" in names
for new in ("models.encoder", "storage", "storage.knn", "storage.knn_check", "ops.quant",
            "ops.json_fsm", "ops.sampling", "serving.streaming", "storage.ann",
            "storage.durable", "storage.integrity", "conf", "cli.ann", "models.mixtral",
            "ops.moe", "ops.speculative"):
    assert "django_assistant_bot_tpu_torch." + new in names, new
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "django_assistant_bot_tpu"))
print(len(names), bad)
assert not bad, bad
"""


def test_port_import_graph_has_no_jax():
    """Importing the package and every submodule (the engine and its copy of
    the scheduler, the encoder, the KNN index, the JSON FSM, the streaming
    plane, the ANN index, its durability plane, the settings, the ANN CLI,
    the MoE MLP and its ops, the speculative drafter and controller among
    them) leaves ``jax`` and the JAX package out of
    ``sys.modules`` (a fresh interpreter: this test process has imported
    both)."""
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 24


def test_port_sources_name_no_jax():
    """No source of the port, nor ``chip_smoke.py``, imports JAX or names a
    module of the JAX package (a text scan, which also covers imports inside
    functions that the import-graph test does not run)."""
    import re
    from pathlib import Path

    import django_assistant_bot_tpu_torch as pkg

    root = Path(pkg.__file__).resolve().parent
    files = sorted(root.rglob("*.py")) + [root.parent / "chip_smoke.py"]
    assert any(f.name == "ann.py" and f.parent.name == "storage" for f in files)
    assert any(f.name == "moe.py" and f.parent.name == "ops" for f in files)
    assert any(f.name == "mixtral.py" and f.parent.name == "models" for f in files)
    assert any(f.name == "speculative.py" and f.parent.name == "ops" for f in files)
    bad = re.compile(r"^\s*(import jax|from jax|import jaxlib|from jaxlib)|"
                     r"django_assistant_bot_tpu\.|from django_assistant_bot_tpu import", re.M)
    for f in files:
        m = bad.search(f.read_text())
        assert m is None, f"{f}: {m.group(0)!r}"


def _needs_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: cuda resolves")


def test_cuda_without_a_card_raises():
    _needs_no_card()
    from django_assistant_bot_tpu_torch import resolve_device

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_entry_points_default_to_cuda():
    """Every entry point defaults to the card and raises without one."""
    _needs_no_card()
    from django_assistant_bot_tpu_torch.cli import main
    from django_assistant_bot_tpu_torch.convert import params_from_jax
    from django_assistant_bot_tpu_torch.models import DecoderConfig, llama
    from django_assistant_bot_tpu_torch.serving import ByteTokenizer, GenerationEngine, ModelRegistry

    cfg = DecoderConfig.tiny()
    params = llama.init(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationEngine(cfg, params, ByteTokenizer())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({}, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelRegistry.from_config({"m": {"tiny": True}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["serve", "--tiny", "--port", "0"])


def test_embedding_entry_points_default_to_cuda():
    """The encoder, the embedding engine, the KNN index, the encoder loader
    and bridge default to the card and raise without one."""
    _needs_no_card()
    from django_assistant_bot_tpu_torch.convert import encoder_params_from_jax
    from django_assistant_bot_tpu_torch.models import EncoderConfig, encoder
    from django_assistant_bot_tpu_torch.models.hf_loader import load_encoder
    from django_assistant_bot_tpu_torch.serving import ByteTokenizer, EmbeddingEngine, ModelRegistry
    from django_assistant_bot_tpu_torch.storage import VectorIndex

    cfg = EncoderConfig.tiny()
    params = encoder.init(cfg, torch.Generator().manual_seed(0), "cpu")
    for call in (
        lambda: encoder.init(cfg, torch.Generator().manual_seed(0)),
        lambda: EmbeddingEngine(cfg, params, ByteTokenizer()),
        lambda: VectorIndex(8),
        lambda: encoder_params_from_jax({}, cfg),
        lambda: load_encoder("no-such-dir"),
        lambda: ModelRegistry.from_config({"e": {"kind": "encoder", "tiny": True}}),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_ann_entry_points_default_to_cuda(tmp_path):
    """The ANN index, its durable wrapper, the bridge and ``cli ann`` default
    to the card and raise without one."""
    _needs_no_card()
    from django_assistant_bot_tpu_torch.cli import main
    from django_assistant_bot_tpu_torch.convert import ann_from_jax
    from django_assistant_bot_tpu_torch.storage import ANNIndex, DurableANN

    for call in (
        lambda: ANNIndex(8),
        lambda: DurableANN(str(tmp_path / "d"), dim=8),
        lambda: ann_from_jax({"dim": 8, "nlist": 0, "m": 0, "nprobe": 0, "rerank_depth": 256}),
        lambda: main(["ann", "train", "--synthetic", "64", "--dim", "8"]),
        lambda: main(["ann", "restore", "--dir", str(tmp_path / "e"), "--dim", "8"]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_every_kernel_has_its_launch_function():
    """Each kernel ``kernels.py`` builds has the launch function of its name
    (the one that counts its launches), and the sampler's launch plan is
    one block a row below the hierarchical vocab."""
    from django_assistant_bot_tpu_torch import kernels

    for name in kernels.KERNELS:
        assert callable(getattr(kernels, name, None)), name
    assert kernels.sample_splits(8, 512) == 1
    assert kernels.sample_splits(8, 128256) == 33
    assert kernels.sample_splits(1, 128256) == 125


def test_kernel_bindings_match_c_entry_points():
    """Each ctypes binding in ``kernels.py`` has the C signature of the
    ``extern "C"`` function it names in ``csrc/`` (pointers, ints and long
    longs, in order): a mismatch would corrupt the launch on the card."""
    import ctypes
    import re

    from django_assistant_bot_tpu_torch import kernels

    kinds = {"int": ctypes.c_int, "long long": ctypes.c_longlong}

    def kind(decl: str):
        if "*" in decl:
            return ctypes.c_void_p
        return kinds[re.sub(r"\s+\w+$", "", decl.strip())]

    bindings = []
    for name, (stem, symbol) in kernels.KERNELS.items():
        bindings.append((stem, symbol, kernels._ARGTYPES[name], ctypes.c_int))
        for extra, (argtypes, restype) in kernels._EXTRA_SYMBOLS.get(name, {}).items():
            bindings.append((stem, extra, argtypes, restype))
    for stem, symbol, argtypes, restype in bindings:
        src = (kernels.CSRC / f"{stem}.cu").read_text()
        m = re.search(r'extern "C" ([\w ]+?) ' + symbol + r"\(([^)]*)\)", src)
        assert m, f"{symbol} not in {stem}.cu"
        assert kinds[m.group(1)] is restype, symbol
        params = [kind(p) for p in m.group(2).split(",")]
        assert params == list(argtypes), symbol


def test_kernel_sources_name_what_they_replace_and_build_lazily():
    """Every kernel source (the paged tree kernel among them) is CUDA C++
    for ``sm_90a`` that names the JAX function it replaces, and importing
    the package builds and loads none of them (a fresh interpreter)."""
    import re

    from django_assistant_bot_tpu_torch import kernels

    stems = {stem for stem, _ in kernels.KERNELS.values()}
    assert "paged_tree" in stems and kernels.KERNELS["paged_tree"][1] == "dabt_paged_tree"
    for stem in stems:
        head = (kernels.CSRC / f"{stem}.cu").read_text()[:3000]
        assert "sm_90a" in head, stem
        assert re.search(r"Replaces: django_assistant_bot_tpu/\S+\.py", head), stem
        assert "#include <torch" not in head, stem
    code = ("import django_assistant_bot_tpu_torch.ops.speculative, "
            "django_assistant_bot_tpu_torch.serving.engine\n"
            "from django_assistant_bot_tpu_torch import kernels\n"
            "assert not kernels.loaded(), kernels.loaded()\n"
            "print(sorted(kernels.LAUNCHES))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "paged_tree" in out.stdout
