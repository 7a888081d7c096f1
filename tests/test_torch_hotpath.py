"""No device-to-host sync on the port's decode hot path (the JAX package's
DABT104 rule, applied to the port by a scan of its source).

The roots are the engine's tick issue and processing (``_issue_tick``,
``_process_tick``), the stream push (``_note_token``, ``_notify_streams``,
``TokenStream.push_token`` / ``notify_now``) and the observability hooks
(``EngineObs.on_*``); every ``self.<method>`` they reach inside their class
is scanned too.  A ``.item()``, ``.cpu()``, ``.tolist()`` or
``torch.cuda.synchronize`` there would stall the pipelined tick.  The one
wait the pipeline has by design, ``_HostCopy.numpy`` (an event sync on a
copy issued ``lookahead`` ticks earlier), is a method of another class and
not a root.
"""

import ast
import inspect

import pytest

from django_assistant_bot_tpu_torch.serving import engine, obs, streaming

SYNC_ATTRS = {"item", "cpu", "tolist", "synchronize"}


def _methods(cls) -> dict:
    tree = ast.parse(inspect.getsource(cls).lstrip())
    (node,) = tree.body
    return {f.name: f for f in node.body if isinstance(f, ast.FunctionDef)}


def _reach(methods: dict, roots) -> list:
    seen, stack = [], list(roots)
    while stack:
        name = stack.pop()
        if name in seen or name not in methods:
            continue
        seen.append(name)
        for n in ast.walk(methods[name]):
            if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                    and isinstance(n.func.value, ast.Name) and n.func.value.id == "self"):
                stack.append(n.func.attr)
    return seen


def _syncs(fn: ast.FunctionDef) -> list:
    return [f"{fn.name}:{n.lineno} .{n.func.attr}()" for n in ast.walk(fn)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr in SYNC_ATTRS]


CASES = [
    (engine.GenerationEngine, ("_issue_tick", "_process_tick", "_note_token",
                               "_notify_streams")),
    (streaming.TokenStream, ("push_token", "notify_now", "finish")),
    (obs.EngineObs, None),  # every on_* hook
]


@pytest.mark.parametrize("cls,roots", CASES, ids=[c.__name__ for c, _ in CASES])
def test_decode_hot_path_has_no_host_sync(cls, roots):
    methods = _methods(cls)
    if roots is None:
        roots = [m for m in methods if m.startswith("on_")]
        assert len(roots) >= 5
    reached = _reach(methods, roots)
    assert set(roots) <= set(reached)
    found = [s for name in reached for s in _syncs(methods[name])]
    assert not found, found


def test_scan_catches_a_planted_sync():
    """The scan is not vacuous: a sync two calls below a root is found."""
    src = '''
class E:
    def _issue_tick(self):
        self._helper()

    def _helper(self):
        self._deeper()

    def _deeper(self):
        return self._toks.tolist()
'''
    (node,) = ast.parse(src).body
    methods = {f.name: f for f in node.body}
    reached = _reach(methods, ["_issue_tick"])
    assert [s for n in reached for s in _syncs(methods[n])] == ["_deeper:10 .tolist()"]


def test_moe_layer_has_no_host_sync():
    """The MoE MLP a decode step (and its CUDA graph) runs: ``moe_mlp``, the
    three wrappers' card paths and their launch functions read nothing on
    the host (no ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``nonzero`` /
    synchronize): the capacity depends on the shape alone and the experts'
    fills stay on the card."""
    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.models import mixtral
    from django_assistant_bot_tpu_torch.ops import moe

    fns = [mixtral.moe_mlp, mixtral.expert_capacity, moe.moe_route, moe.moe_expert_gemm,
           moe.moe_combine, kernels.moe_route, kernels.moe_gemm, kernels.moe_combine]
    found = []
    for fn in fns:
        (node,) = ast.parse(inspect.getsource(fn)).body
        found += _syncs(node)
        found += [f"{fn.__name__}:{n.lineno} nonzero" for n in ast.walk(node)
                  if isinstance(n, ast.Attribute) and n.attr == "nonzero"]
    assert not found, found


def test_spec_tick_is_scanned_and_has_no_host_sync():
    """The speculative tick is on the scanned path (its issue, launch, body
    and processing are reached from the roots), and what its body runs (the
    drafter, acceptance, the verify forward, the paged tree wrapper's card
    path and launch function, the commit) reads nothing on the host: each
    verify step's graph replays with no host round trip."""
    import importlib

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.models import llama
    from django_assistant_bot_tpu_torch.ops import speculative

    attention = importlib.import_module("django_assistant_bot_tpu_torch.ops.attention")
    reached = _reach(_methods(engine.GenerationEngine), ("_issue_tick", "_process_tick"))
    for name in ("_issue_spec_tick", "_launch_spec_tick", "_spec_tick_body",
                 "_process_spec_tick"):
        assert name in reached, name
    fns = [speculative.build_tree_draft, speculative.flatten_tree, speculative.accept_tree,
           llama.verify_tree_step_paged, llama._gather_tree_path,
           llama.commit_tree_path_paged, attention.paged_tree_attention,
           kernels.paged_tree, kernels.paged_tree_plan]
    found = []
    for fn in fns:
        (node,) = ast.parse(inspect.getsource(fn)).body
        found += _syncs(node)
        found += [f"{fn.__name__}:{n.lineno} int()" for n in ast.walk(node)
                  if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                  and n.func.id in ("int", "float", "bool") and n.args
                  and isinstance(n.args[0], ast.Call)
                  and isinstance(n.args[0].func, ast.Attribute)
                  and n.args[0].func.attr in ("max", "min", "sum", "any", "all")]
    assert not found, found
