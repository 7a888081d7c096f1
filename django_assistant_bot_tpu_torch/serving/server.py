"""Model server, aiohttp (port of ``serving/server.py``: ``/embeddings/``,
``/dialog/`` and the read-only endpoints).

- ``POST /embeddings/`` (and ``/embeddings``) ``{model, texts}`` ->
  ``{"embeddings": [[...], ...]}``; 422 on a bad body, 400 "Model is not
  supported" for an unknown model, 429 with ``Retry-After`` when the
  embedding queue sheds, 500 with detail on failure.
- ``POST /dialog/`` (and ``/dialog``) ``{model, messages, max_tokens,
  temperature, top_p, json_format, stream, priority, tenant, deadline_s}``
  -> ``{"response": {"result", "usage", "length_limited"}, "request_id"}``;
  ``json_format`` constrains the result to one JSON object or array;
  ``"stream": true`` answers ``text/event-stream`` instead (the JAX wire
  format): a ``data:`` event per text delta ``{"delta", "index"}``, a
  terminal ``{"done": true, "finish_reason", "result", "usage",
  "length_limited", "request_id"}``, then ``data: [DONE]``; a failure after
  the first token is an event with ``"finish_reason": "error"``, one before
  it maps to its status as without streaming.  ``stream`` with
  ``json_format`` is refused with a 422.  422 on a bad body,
  400 "Model is not supported" for an unknown model, 429 with
  ``Retry-After`` when the scheduler sheds the request, 504 when its
  deadline expires, 503 with ``Retry-After`` while the engine's restart
  circuit is open, 500 with detail on failure.  ``priority``, ``tenant``
  and ``deadline_s`` may also come as ``X-Priority``, ``X-Tenant`` and
  ``X-Deadline-S`` headers.  The correlation id is the client's token-safe
  ``X-Request-Id`` or a fresh one, echoed in the body and the header.
- ``GET /healthz``: per generator the engine's gauges, its ``kv`` block,
  its ``supervision`` block (restarts, quarantines, circuit, heartbeat) and
  its scheduler's ``sched`` block; ``status`` is ``degraded`` while any
  engine is unhealthy; per embedder its queue depth, bound, sheds and
  cancelled drops.  ``GET /models``.
- ``GET /metrics``: Prometheus text exposition (:func:`.obs.render_prometheus`).

The fleet endpoints come with a later slice (ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

import asyncio
import json
import logging
import math
import re
import uuid
from typing import Any, Mapping, Optional

from aiohttp import web

from .engine import EngineUnavailable
from .obs import render_prometheus
from .registry import ModelRegistry
from .scheduler import DeadlineExceeded, SchedulerRejected

logger = logging.getLogger(__name__)

REGISTRY_KEY: web.AppKey[ModelRegistry] = web.AppKey("registry", ModelRegistry)

MAX_MAX_TOKENS = 1 << 17  # sanity ceiling; engines clamp to max_seq_len anyway

_REQ_ID_RE = re.compile(r"^[A-Za-z0-9._:-]{1,64}$")

PRIORITIES = ("interactive", "background")


class _BadRequest(ValueError):
    """Validation failure carrying the client-facing detail message."""


def _request_id(request: web.Request) -> str:
    rid = request.headers.get("X-Request-Id", "").strip()
    if rid and _REQ_ID_RE.match(rid):
        return rid
    return uuid.uuid4().hex[:16]


def _error_response(detail: str, status: int, rid: str) -> web.Response:
    return web.json_response(
        {"detail": detail, "request_id": rid}, status=status, headers={"X-Request-Id": rid}
    )


def _validate_sampling(body: Mapping[str, Any]) -> tuple:
    """Pull and range-check the sampling knobs (the JAX server's rules)."""
    temperature = body.get("temperature", 0.8)
    top_p = body.get("top_p", 0.95)
    max_tokens = body.get("max_tokens", 1024)
    if isinstance(temperature, bool) or not isinstance(temperature, (int, float)):
        raise _BadRequest("temperature must be a number")
    temperature = float(temperature)
    if not math.isfinite(temperature) or not (0.0 <= temperature <= 2.0):
        raise _BadRequest("temperature must be finite and within [0, 2]")
    if isinstance(top_p, bool) or not isinstance(top_p, (int, float)):
        raise _BadRequest("top_p must be a number")
    top_p = float(top_p)
    if not math.isfinite(top_p) or not (0.0 < top_p <= 1.0):
        raise _BadRequest("top_p must be finite and within (0, 1]")
    if isinstance(max_tokens, bool) or not isinstance(max_tokens, int):
        raise _BadRequest("max_tokens must be an integer")
    if not (1 <= max_tokens <= MAX_MAX_TOKENS):
        raise _BadRequest(f"max_tokens must be within [1, {MAX_MAX_TOKENS}]")
    return temperature, top_p, max_tokens


def _scheduling_fields(
    request: web.Request, body: Mapping[str, Any]
) -> tuple[str, str, Optional[float]]:
    """Priority class, fair-share tenant and deadline (the JAX server's
    rules): body fields win, ``X-Priority`` / ``X-Tenant`` /
    ``X-Deadline-S`` headers are the fallback."""
    priority = body.get("priority", request.headers.get("X-Priority", "interactive"))
    if priority not in PRIORITIES:
        raise _BadRequest(f"priority must be one of {list(PRIORITIES)}")
    tenant = body.get("tenant", request.headers.get("X-Tenant", "default"))
    if not isinstance(tenant, str) or not tenant.strip() or len(tenant) > 128:
        raise _BadRequest("tenant must be a non-empty string of <= 128 chars")
    deadline_s = body.get("deadline_s", request.headers.get("X-Deadline-S"))
    if deadline_s is not None:
        try:
            deadline_s = float(deadline_s)
        except (TypeError, ValueError):
            raise _BadRequest("deadline_s must be a number") from None
        if not math.isfinite(deadline_s) or not (0.0 < deadline_s <= 3600.0):
            raise _BadRequest("deadline_s must be finite and within (0, 3600]")
    return priority, tenant.strip(), deadline_s


def _shed_response(e: SchedulerRejected, rid: str) -> web.Response:
    """Load shed -> 429 with a Retry-After back-off hint (JAX wire format)."""
    retry = max(1, math.ceil(e.retry_after_s))
    return web.json_response(
        {"detail": str(e), "reason": e.reason, "retry_after_s": e.retry_after_s,
         "request_id": rid},
        status=429,
        headers={"Retry-After": str(retry), "X-Request-Id": rid},
    )


def _unavailable_response(e: EngineUnavailable, rid: str) -> web.Response:
    """Restart circuit open -> 503 with a Retry-After covering the remaining
    degraded cooldown (JAX wire format)."""
    retry = max(1, math.ceil(e.retry_after_s))
    return web.json_response(
        {"detail": str(e), "retry_after_s": e.retry_after_s, "request_id": rid},
        status=503,
        headers={"Retry-After": str(retry), "X-Request-Id": rid},
    )


def _sse(payload) -> bytes:
    data = payload if isinstance(payload, str) else json.dumps(payload)
    return f"data: {data}\n\n".encode("utf-8")


async def _stream_dialog(request: web.Request, eng, model: str, messages, rid: str,
                         **gen_kwargs) -> web.StreamResponse:
    """``"stream": true`` -> ``text/event-stream``.  The first chunk is
    awaited before the response is prepared, so a shed, an open circuit, an
    expired deadline or a failure before the first token maps to its status
    as without streaming; later failures become an ``error`` event.  A
    client that disconnects abandons the generator, whose cleanup cancels
    the request: the loop's reap frees its slot within one tick."""
    agen = eng.generate_stream(messages, trace_id=rid, **gen_kwargs)
    try:
        first = await agen.__anext__()
    except StopAsyncIteration:
        first = None
    except SchedulerRejected as e:
        return _shed_response(e, rid)
    except EngineUnavailable as e:
        return _unavailable_response(e, rid)
    except DeadlineExceeded as e:
        return _error_response(str(e), 504, rid)
    except Exception as e:
        logger.exception("stream dialog failed before its first token")
        return _error_response(str(e), 500, rid)

    resp = web.StreamResponse(status=200, headers={
        "Content-Type": "text/event-stream", "Cache-Control": "no-cache",
        "X-Accel-Buffering": "no", "X-Request-Id": rid,
    })
    await resp.prepare(request)
    try:
        chunk = first
        while chunk is not None:
            if request.transport is None or request.transport.is_closing():
                # gone while its tokens decode to no text yet (nothing was
                # written that could have failed): stop here all the same
                raise ConnectionResetError("stream client disconnected")
            if chunk.done:
                if chunk.text:  # the held-back tail rides its own event
                    await resp.write(_sse({"delta": chunk.text, "index": chunk.index}))
                r = chunk.result
                await resp.write(_sse({
                    "done": True, "finish_reason": chunk.finish_reason, "result": r.text,
                    "usage": r.usage_dict(model), "length_limited": r.length_limited,
                    "request_id": rid,
                }))
                break
            if chunk.text:
                await resp.write(_sse({"delta": chunk.text, "index": chunk.index}))
            try:
                chunk = await agen.__anext__()
            except StopAsyncIteration:
                break
        await resp.write(_sse("[DONE]"))
        await resp.write_eof()
    except asyncio.CancelledError:
        # the handler was cancelled (the client went away): the finally's
        # aclose() cancels the request
        logger.info("stream client disconnected mid-generation")
        raise
    except ConnectionError:
        # a write found the connection closed: the same, without a traceback
        logger.info("stream client disconnected mid-generation")
    except Exception as e:
        # the response is committed to 200: the failure becomes an event
        logger.exception("stream dialog failed mid-stream")
        try:
            await resp.write(_sse({"done": True, "finish_reason": "error", "error": str(e),
                                   "request_id": rid}))
            await resp.write(_sse("[DONE]"))
            await resp.write_eof()
        except ConnectionError:
            pass
    finally:
        await agen.aclose()
    return resp


def create_app(registry: ModelRegistry) -> web.Application:
    app = web.Application()
    app[REGISTRY_KEY] = registry

    async def embeddings(request: web.Request) -> web.Response:
        rid = _request_id(request)
        try:
            body = await request.json()
            model, texts = body["model"], body["texts"]
            if not isinstance(model, str):
                raise ValueError("model must be a string")
            if not isinstance(texts, list) or not all(isinstance(t, str) for t in texts):
                raise ValueError("texts must be a list of strings")
        except Exception:
            return web.json_response({"detail": "invalid request"}, status=422)
        eng = registry.get_embedder(model)
        if eng is None:
            return web.json_response({"detail": "Model is not supported"}, status=400)
        try:
            embs = await eng.embed(texts)
        except SchedulerRejected as e:
            return _shed_response(e, rid)
        except Exception as e:
            logger.exception("embeddings failed")
            return web.json_response({"detail": str(e)}, status=500)
        return web.json_response({"embeddings": embs})

    async def dialog(request: web.Request) -> web.Response:
        rid = _request_id(request)
        try:
            body = await request.json()
            model = body["model"]
            if not isinstance(model, str):
                raise ValueError("model must be a string")
            messages = body["messages"]
            if not isinstance(messages, list):
                raise ValueError("messages must be a list")
            json_format = bool(body.get("json_format", False))
            stream = body.get("stream", False)
            if not isinstance(stream, bool):
                raise _BadRequest("stream must be a boolean")
            if stream and json_format:
                # partial JSON is not independently consumable (the JAX choice)
                raise _BadRequest(
                    "stream is not supported with json_format; request one or the other"
                )
            temperature, top_p, max_tokens = _validate_sampling(body)
            priority, tenant, deadline_s = _scheduling_fields(request, body)
        except _BadRequest as e:
            return _error_response(str(e), 422, rid)
        except Exception:
            return _error_response("invalid request", 422, rid)
        eng = registry.get_generator(model)
        if eng is None:
            return _error_response("Model is not supported", 400, rid)
        if stream:
            return await _stream_dialog(
                request, eng, model, messages, rid, max_tokens=max_tokens,
                temperature=temperature, top_p=top_p, priority=priority, tenant=tenant,
                deadline_s=deadline_s,
            )
        try:
            result = await eng.generate(
                messages, max_tokens=max_tokens, temperature=temperature, top_p=top_p,
                json_format=json_format, priority=priority, tenant=tenant,
                deadline_s=deadline_s, trace_id=rid,
            )
        except SchedulerRejected as e:
            return _shed_response(e, rid)
        except EngineUnavailable as e:
            return _unavailable_response(e, rid)
        except DeadlineExceeded as e:
            return _error_response(str(e), 504, rid)
        except Exception as e:
            logger.exception("dialog failed")
            return _error_response(str(e), 500, rid)
        return web.json_response(
            {
                "response": {
                    "result": result.text,
                    "usage": result.usage_dict(model),
                    "length_limited": result.length_limited,
                },
                "request_id": rid,
            },
            headers={"X-Request-Id": rid},
        )

    async def healthz(request: web.Request) -> web.Response:
        generators = {name: eng.stats() for name, eng in registry.generators.items()}
        healthy = all(g["supervision"]["healthy"] for g in generators.values())
        return web.json_response(
            {
                "status": "ok" if healthy else "degraded",
                "models": sorted(registry.specs),
                "generators": generators,
                "embedders": {
                    name: {
                        "queue_depth": eng._queue.qsize(),
                        "max_queue": eng.max_queue,
                        "shed": eng.shed,
                        "dropped_cancelled": eng.dropped_cancelled,
                    }
                    for name, eng in registry.embedders.items()
                },
            }
        )

    async def metrics(request: web.Request) -> web.Response:
        try:
            text = render_prometheus(registry)
        except Exception:
            logger.exception("/metrics render failed")
            return web.Response(status=500, text="metrics render failed")
        return web.Response(
            body=text.encode("utf-8"),
            headers={"Content-Type": "text/plain; version=0.0.4; charset=utf-8"},
        )

    async def models(request: web.Request) -> web.Response:
        return web.json_response(
            {
                name: {"kind": spec.kind, "path": spec.path, "tiny": spec.tiny}
                for name, spec in registry.specs.items()
            }
        )

    app.router.add_post("/embeddings/", embeddings)
    app.router.add_post("/embeddings", embeddings)
    app.router.add_post("/dialog/", dialog)
    app.router.add_post("/dialog", dialog)
    app.router.add_get("/healthz", healthz)
    app.router.add_get("/models", models)
    app.router.add_get("/metrics", metrics)

    async def on_cleanup(app):
        registry.stop()

    app.on_cleanup.append(on_cleanup)
    return app


def load_config_file(path: str) -> Mapping[str, Any]:
    """TOML or JSON model config: ``[models.<name>] kind=... path=...``."""
    if path.endswith(".toml"):
        import tomllib

        with open(path, "rb") as f:
            data = tomllib.load(f)
    else:
        with open(path) as f:
            data = json.load(f)
    return data.get("models", data)


def run_server(registry: ModelRegistry, *, host: str = "0.0.0.0", port: int = 11435):
    """Blocking entry (CLI ``serve``); the default port matches the reference's."""
    web.run_app(create_app(registry), host=host, port=port)
