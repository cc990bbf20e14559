"""OpenAI-compatible serving surface: /v1/completions + /v1/chat/completions
(counterpart of ``modelx_tpu/dl/openai_api.py``).

The veneer over the native token-id API that lets stock OpenAI SDK clients
point at the sidecar unchanged (``base_url=http://sidecar:8000/v1``). The
request checks, status codes and JSON/SSE bodies are the JAX sidecar's.

- ``prompt``: str or list of str (each row generated in turn); ``messages``:
  the role/content list, rendered through the model's own ``chat_template``
  (tokenizer_config.json; sandboxed jinja with the HF conventions, encoded
  with add_special_tokens=False) or, without one, the generic
  ``<|role|>\\n{content}\\n`` ... ``<|assistant|>\\n``.
- ``max_tokens`` / ``max_completion_tokens``, ``temperature``, ``top_p``,
  ``seed``, ``stop`` (up to 4 strings), ``stream`` (SSE), ``top_k`` and
  ``ignore_eos`` as extensions.
- ``n``: each prompt decodes n samples in one call (per-row seed streams).
- ``logprobs``: completions take the integer form (0-5), chat
  ``logprobs: true`` + ``top_logprobs`` (0-20). The values come from a
  scoring forward over prompt + completion after generation
  (``ModelServer.score_logprobs_rows``: the cache-free forward, which runs
  the flash kernel on the card); non-streaming only.
- ``echo`` and tool calls: a clear 400.
- ``resume`` on a stream (the native block or the ``X-ModelX-Resume-*``
  headers): the continuous engine continues the stream from the emitted
  tokens' text; without it the pod refuses as the JAX sidecar does.

Requires the model to ship a ``tokenizer.json``, read by the port's own
reader (``dl/tokenizer.py``).
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from modelx_tpu_torch.dl.serve import ChatTemplateRejected, NotPortedError
from modelx_tpu_torch.dl.serving_errors import (
    MalformedResumeError,
    ResumeExhaustedError,
    deadline_kwargs,
)
from modelx_tpu_torch.models.decode import stop_cut

logger = logging.getLogger("modelx.serve")

OBJ_COMPLETION = "text_completion"
OBJ_CHAT = "chat.completion"
OBJ_CHAT_CHUNK = "chat.completion.chunk"

_UNSUPPORTED = ("echo", "tools", "tool_choice", "functions")

MAX_PROMPTS = 32  # one request must stay one bounded unit of device work


class APIError(Exception):
    """OpenAI-shaped error: {"error": {"message", "type", "param", "code"}};
    ``headers`` ride to the transport (Retry-After on a still-loading 503)."""

    def __init__(self, status: int, message: str, err_type: str = "invalid_request_error",
                 headers: dict | None = None) -> None:
        super().__init__(message)
        self.status = status
        self.headers = dict(headers or {})
        self.payload = {
            "error": {"message": message, "type": err_type, "param": None, "code": None}
        }


def api_error_for(e) -> APIError:
    """One OpenAI payload per typed serving failure: the exception's status,
    ``api_type`` and headers, the same on the streaming and the
    non-streaming path."""
    return APIError(e.http_status, str(e), e.api_type, headers=e.headers())


def resolve_model(sset, req: dict):
    """The ``model`` field picks the tenant; absent = the default. Names in
    a lifecycle transition (``dl/lifecycle.py``) map as on the native
    surface: PULLING/LOADING 503 + Retry-After, DRAINING 409, FAILED 503
    with the reason (the HTTP handler gates first; library callers of
    ``run_completion`` get the same answers here)."""
    from modelx_tpu_torch.dl.serving_errors import ServingError

    name = req.get("model") or sset.default
    server = sset.servers.get(name)
    pool = getattr(sset, "pool", None)
    if pool is not None:
        try:
            pool.check_admission(name)
        except ServingError as e:
            raise api_error_for(e) from e
    if server is None:
        raise APIError(404, f"model {name!r} not found", "not_found_error")
    if not server.ready:
        raise APIError(503, f"model {name!r} is still loading", "server_error",
                       headers={"Retry-After": "2"})
    return server


def tokenizer_for(server):
    try:
        tok = server.tokenizer()
    except RuntimeError as e:
        raise APIError(503, str(e), "server_error") from e
    except NotPortedError as e:
        raise APIError(e.http_status, str(e), "not_ported") from e
    if tok is None:
        raise APIError(
            400, "model has no tokenizer.json; use the token-id API (/v1/generate)"
        )
    return tok


def render_messages(messages, spec: dict | None = None) -> str:
    """Messages -> prompt text: through the model's template (``spec``,
    ModelServer.chat_template) with ``add_generation_prompt=True`` and the
    bos/eos tokens, else the generic role template."""
    if not isinstance(messages, list) or not messages:
        raise APIError(400, "messages must be a non-empty list")
    for i, m in enumerate(messages):
        if not isinstance(m, dict) or not isinstance(m.get("content"), str):
            raise APIError(400, f"messages[{i}] must be {{role, content}} with string content")
        role = m.get("role", "user")
        if not isinstance(role, str) or (
            spec is None and role not in ("system", "user", "assistant")
        ):
            # the generic template only knows the three core roles; a model
            # template validates roles itself (raise_exception)
            raise APIError(400, f"messages[{i}].role must be system|user|assistant")
    if spec is not None and not spec.get("broken"):
        render_kwargs = dict(
            add_generation_prompt=True,
            bos_token=spec.get("bos_token", ""),
            eos_token=spec.get("eos_token", ""),
        )
        try:
            return spec["compiled"].render(messages=messages, **render_kwargs)
        except ChatTemplateRejected as e:
            # the template itself said no: the messages break the model's
            # conversation contract
            raise APIError(400, f"chat template rejected the messages: {e}")
        except Exception as e:
            # triage before blaming the client: a render that also fails on
            # a trivial probe is a broken template (a server-side defect),
            # so fall back to the generic template, once, and remember it;
            # failures the probe does not reproduce stay 400
            probe = [{"role": "user", "content": "probe"}]
            try:
                spec["compiled"].render(messages=probe, **render_kwargs)
            except ChatTemplateRejected:
                # the template deliberately rejected the bare probe: template
                # logic working, not breakage
                raise APIError(400, f"chat template failed to render: {e}")
            except Exception:
                spec["broken"] = True
                logger.warning("chat template fails independent of the request (%s); "
                               "falling back to the generic role template", e)
            else:
                raise APIError(400, f"chat template failed to render: {e}")
    parts = [f"<|{m.get('role', 'user')}|>\n{m['content']}\n" for m in messages]
    parts.append("<|assistant|>\n")
    return "".join(parts)


def parse_prompts(req: dict, chat: bool, server=None) -> list[str]:
    if chat:
        spec = server.chat_template() if server is not None else None
        return [render_messages(req.get("messages"), spec)]
    prompt = req.get("prompt")
    if isinstance(prompt, str) and prompt:
        return [prompt]
    if isinstance(prompt, list) and prompt and all(isinstance(p, str) and p for p in prompt):
        if len(prompt) > MAX_PROMPTS:
            raise APIError(400, f"at most {MAX_PROMPTS} prompts per request")
        return prompt
    raise APIError(400, "prompt must be a non-empty string or list of non-empty strings")


def parse_sampling(req: dict, limit: int) -> tuple[int, dict]:
    for key in _UNSUPPORTED:
        if key not in req:
            continue
        # values that ask for nothing (None/False, empty containers) pass
        val = req.get(key)
        if not (val is None or val is False or val == [] or val == {}):
            raise APIError(400, f"{key!r} is not supported")
    try:
        # max_completion_tokens is the current OpenAI name and wins over
        # the deprecated max_tokens
        if "max_completion_tokens" in req and req["max_completion_tokens"] is not None:
            n_tokens = int(req["max_completion_tokens"])
        else:
            n_tokens = int(req.get("max_tokens", 16))
        if "seed" in req:
            seed = int(req["seed"])
        else:
            # OpenAI semantics: no seed means nondeterministic
            seed = int.from_bytes(os.urandom(4), "big") >> 1
        samp = {
            "temperature": float(req.get("temperature", 1.0)),
            "top_k": int(req.get("top_k", 0)),
            "top_p": float(req.get("top_p", 1.0)),
            "seed": seed,
        }
    except (TypeError, ValueError):
        raise APIError(
            400,
            "max_tokens/max_completion_tokens/temperature/top_k/top_p/seed "
            "must be numbers",
        ) from None
    if not (1 <= n_tokens <= limit):
        raise APIError(400, f"max_tokens/max_completion_tokens must be in [1, {limit}]")
    if not (0.0 <= samp["temperature"] <= 2.0):
        raise APIError(400, "temperature must be in [0, 2]")
    if not (0.0 < samp["top_p"] <= 1.0):
        raise APIError(400, "top_p must be in (0, 1]")
    if not (0 <= samp["top_k"] < 2**31) or not (0 <= samp["seed"] < 2**31):
        raise APIError(400, "top_k/seed must be in [0, 2^31)")
    return n_tokens, samp


def parse_n(req: dict, prompts: int, limit: int = MAX_PROMPTS) -> int:
    """``n`` samples per prompt; prompts x n stays under the prompt cap. An
    explicit null means the default 1."""
    n = req.get("n")
    if n is None:
        return 1
    if isinstance(n, bool) or not isinstance(n, int) or n < 1:
        raise APIError(400, "n must be a positive integer")
    if prompts * n > limit:
        raise APIError(400, f"prompt count x n must not exceed {limit}")
    return n


def parse_logprobs(req: dict, chat: bool) -> int | None:
    """Requested alternatives per position, or None when logprobs are off.
    Completions: ``logprobs: k``, 0 <= k <= 5. Chat: ``logprobs: true`` with
    an optional ``top_logprobs`` (0-20), which rides only with
    logprobs=true. Explicit null/false mean off."""
    val = req.get("logprobs")
    if chat:
        if val is None or val is False:
            if req.get("top_logprobs") is not None:
                raise APIError(400, "top_logprobs requires logprobs: true")
            return None
        if val is not True:
            raise APIError(400, "logprobs must be a boolean for chat")
        k = req.get("top_logprobs")
        if k is None:
            return 0
        if isinstance(k, bool) or not isinstance(k, int) or not (0 <= k <= 20):
            raise APIError(400, "top_logprobs must be an integer in [0, 20]")
        return k
    if val is None or val is False:
        return None
    if isinstance(val, bool) or not isinstance(val, int) or not (0 <= val <= 5):
        raise APIError(400, "logprobs must be an integer in [0, 5]")
    return val


def logprobs_trim(tok, new_ids: list[int], text_len: int):
    """(kept_ids, token_strs, offsets): the content tokens whose text
    survived stop-sequence truncation (``text_len`` < 0 keeps all), with
    cumulative per-token offsets."""
    token_strs = [tok.decode([int(t)]) for t in new_ids]
    offsets, off, keep = [], 0, 0
    for s in token_strs:
        if 0 <= text_len <= off:
            break
        offsets.append(off)
        off += len(s)
        keep += 1
    return new_ids[:keep], token_strs[:keep], offsets


def logprobs_shape(tok, token_strs: list[str], offsets: list[int],
                   scores, k: int, chat: bool) -> dict:
    """OpenAI-shaped logprobs for one choice from ``scores``
    ((token_lps, top_ids, top_lps), ModelServer.score_logprobs_rows)."""
    token_lps, top_ids, top_lps = scores
    if chat:
        content = []
        for i, s in enumerate(token_strs):
            content.append({
                "token": s,
                "logprob": float(token_lps[i]),
                "bytes": list(s.encode()),
                "top_logprobs": [
                    {"token": tok.decode([int(tid)]), "logprob": float(tlp),
                     "bytes": list(tok.decode([int(tid)]).encode())}
                    for tid, tlp in zip(top_ids[i], top_lps[i])
                ] if k else [],
            })
        return {"content": content}
    return {
        "tokens": token_strs,
        "token_logprobs": [float(x) for x in token_lps],
        # the classic completions format keys alternatives by token text:
        # distinct ids that decode alike collapse, as in OpenAI's own
        "top_logprobs": (
            [
                {tok.decode([int(tid)]): float(tlp) for tid, tlp in zip(row_i, row_l)}
                for row_i, row_l in zip(top_ids, top_lps)
            ] if k else None
        ),
        "text_offset": offsets,
    }


def parse_stop(req: dict) -> list[str]:
    stop = req.get("stop")
    if stop is None:
        return []
    if isinstance(stop, str):
        stop = [stop]
    if not isinstance(stop, list) or len(stop) > 4 or not all(
            isinstance(s, str) and s for s in stop):
        raise APIError(400, "stop must be a string or a list of up to 4 non-empty strings")
    return stop


def apply_stop(text: str, stops: list[str]) -> tuple[str, str]:
    """(truncated text, finish_reason): cut at the earliest stop match."""
    cut = len(text)
    for s in stops:
        i = text.find(s)
        if i >= 0:
            cut = min(cut, i)
    if cut < len(text):
        return text[:cut], "stop"
    return text, "length"


def encode_prompt(tok, server, text: str, n_tokens: int = 0,
                  add_special_tokens: bool = True) -> list[int]:
    ids = tok.encode(text, add_special_tokens=add_special_tokens)
    if not ids:
        raise APIError(400, "prompt tokenized to zero tokens")
    vocab = getattr(server.cfg, "vocab_size", 0) or 0
    if vocab and (min(ids) < 0 or max(ids) >= vocab):
        raise APIError(400, f"tokenizer produced ids outside the model vocab [0, {vocab})")
    n_pos = getattr(server.cfg, "n_positions", 0) or 0
    if n_pos and len(ids) + n_tokens > n_pos:
        raise APIError(
            400,
            f"prompt ({len(ids)} tokens) + max_tokens ({n_tokens}) exceeds "
            f"the model's {n_pos}-position context",
        )
    return ids


def _envelope(obj_type: str, model: str) -> dict:
    return {
        "id": f"cmpl-{uuid.uuid4().hex[:24]}",
        "object": obj_type,
        "created": int(time.time()),
        "model": model,
    }


def eos_for(tok, req: dict) -> tuple[int, ...]:
    """The tokenizer's end-of-sequence ids, unless the request opts out with
    ``ignore_eos``. Generation ends at EOS with finish_reason "stop" and
    the EOS token never appears in the content."""
    ignore = req.get("ignore_eos", False)
    if not isinstance(ignore, bool):
        raise APIError(400, "ignore_eos must be a boolean")
    if ignore or not hasattr(tok, "eos_ids"):
        return ()
    return tok.eos_ids()


def run_completion(sset, req: dict, chat: bool, timeout_s: float | None = None,
                   priority: str = "interactive", timing: dict | None = None) -> dict:
    """Non-streaming completions/chat: returns the OpenAI response body.
    Under the dynamic batcher the prompts are submitted together and decode
    as one ragged device call; otherwise one after another. The continuous
    engine frees a row's slot at its EOS and honors the propagated deadline
    remainder and priority class (``timeout_s``, ``priority``) and fills
    ``timing``; other engines decode the full budget and the EOS trim
    happens here."""
    server = resolve_model(sset, req)
    tok = tokenizer_for(server)
    prompts = parse_prompts(req, chat, server)
    # a model chat template carries its own special tokens: encode raw
    raw_encode = chat and server.chat_template() is not None
    n_tokens, samp = parse_sampling(req, sset.max_new_tokens_limit)
    n_samples = parse_n(req, len(prompts))
    top_lp = parse_logprobs(req, chat)
    stops = parse_stop(req)
    eos = eos_for(tok, req)

    if req.get("stream_options") is not None:
        # OpenAI contract: only valid with stream=true
        raise APIError(400, "stream_options is only allowed when stream is true")
    engine = sset.engine_for(server, len(prompts) * n_samples, samp["temperature"])
    server.stats["requests"] += 1
    id_rows = [
        encode_prompt(tok, server, text, n_tokens, add_special_tokens=not raw_encode)
        for text in prompts
    ]
    engine_kw: dict = {}
    if engine is sset.continuous_for(server):
        if eos:
            engine_kw["stop_token_ids"] = list(eos)
        engine_kw.update(deadline_kwargs(timeout_s, priority))
        if timing is not None:
            engine_kw["timing"] = timing

    def _one(ids: list[int]) -> list[list[int]]:
        # n samples of one prompt = n rows of the same ids in one call: the
        # engine derives per-row (seed + i) streams, OpenAI's n semantics
        out = engine.generate(np.asarray([ids] * n_samples, np.int32),
                              max_new_tokens=n_tokens, **engine_kw, **samp)
        return [row[len(ids):].tolist() for row in out]

    if len(id_rows) > 1 and engine is not server:
        # concurrent submissions ride the batcher's window and decode as
        # one ragged device call
        with ThreadPoolExecutor(max_workers=len(id_rows)) as pool:
            rows_out = list(pool.map(_one, id_rows))
    else:
        rows_out = [_one(ids) for ids in id_rows]

    eos_set = set(eos)
    # usage counts each prompt once, however many samples it produced
    prompt_tokens = sum(len(ids) for ids in id_rows)
    completion_tokens = 0
    built = []  # (kept token strs, offsets, text, finish)
    score_rows = []
    for ids, new_ids in ((i, n) for i, s in zip(id_rows, rows_out) for n in s):
        cut = stop_cut(new_ids, eos_set)
        hit_eos = cut is not None
        if hit_eos:
            new_ids = new_ids[:cut]  # usage counts the EOS; content excludes it
        completion_tokens += len(new_ids)
        content_ids = new_ids[:-1] if hit_eos else new_ids
        text_out, finish = apply_stop(tok.decode(content_ids), stops)
        stop_truncated = finish == "stop"
        if hit_eos and finish == "length":
            finish = "stop"
        strs, offsets = [], []
        if top_lp is not None:
            kept, strs, offsets = logprobs_trim(
                tok, content_ids, len(text_out) if stop_truncated else -1)
            score_rows.append((ids, kept))
        built.append((strs, offsets, text_out, finish))
    scores = server.score_logprobs_rows(score_rows, top_k=top_lp) if top_lp is not None else None
    choices = []
    for i, (strs, offsets, text_out, finish) in enumerate(built):
        lp = None
        if scores is not None:
            lp = logprobs_shape(tok, strs, offsets, scores[i], top_lp, chat)
        if chat:
            choices.append({
                "index": i,
                "message": {"role": "assistant", "content": text_out},
                "logprobs": lp,
                "finish_reason": finish,
            })
        else:
            choices.append({"index": i, "text": text_out, "logprobs": lp,
                            "finish_reason": finish})

    body = _envelope(OBJ_CHAT if chat else OBJ_COMPLETION, server.name)
    body["choices"] = choices
    body["usage"] = {
        "prompt_tokens": prompt_tokens,
        "completion_tokens": completion_tokens,
        "total_tokens": prompt_tokens + completion_tokens,
    }
    return body


def stream_completion(sset, req: dict, chat: bool, timeout_s: float | None = None,
                      priority: str = "interactive", resume=None, request_id: str = "",
                      timing: dict | None = None) -> Iterator[dict]:
    """SSE event bodies for stream=true (one prompt). The first ``next()``
    does all validation and primes the decode, so callers pull one event
    before committing a 200 and bad requests fail with their real status.

    ``resume`` is a parsed ``(emitted_token_ids, seed)`` pair: it is
    validated here (malformed 400, past the budget or EOS 422); the
    continuous engine re-prefills prompt + emitted and continues the
    original (seed, step) stream, and ``stream_source`` refuses it without
    the engine. ``request_id`` joins the engine ticket. ``timing`` is the
    continuous engine's phase breakdown: it rides the opt-in usage chunk
    when the engine filled it."""
    server = resolve_model(sset, req)
    tok = tokenizer_for(server)
    prompts = parse_prompts(req, chat, server)
    raw_encode = chat and server.chat_template() is not None
    if len(prompts) != 1:
        raise APIError(400, "stream supports a single prompt")
    if parse_n(req, 1) != 1:
        raise APIError(400, "n > 1 is not supported with stream")
    if parse_logprobs(req, chat) is not None:
        # logprobs come from a post-generation scoring forward
        raise APIError(400, "logprobs are not supported with stream; use stream: false")
    n_tokens, samp = parse_sampling(req, sset.max_new_tokens_limit)
    stops = parse_stop(req)
    ids = encode_prompt(tok, server, prompts[0], n_tokens, add_special_tokens=not raw_encode)
    if server.family.decode_fns is None:
        # fail before any SSE bytes hit the wire, not mid-stream
        raise APIError(400, f"model family {server.family.name!r} does not support streaming")
    opts = req.get("stream_options")
    if opts is not None and not isinstance(opts, dict):
        raise APIError(400, "stream_options must be an object")
    include_usage = bool((opts or {}).get("include_usage", False))

    eos = eos_for(tok, req)  # validates ignore_eos before counting
    resume_step = 0
    resume_ids: list[int] = []
    if resume is not None:
        emitted, rseed = resume
        vocab = getattr(server.cfg, "vocab_size", 0) or 0
        if vocab and max(emitted) >= vocab:
            raise MalformedResumeError(f"emitted token ids must be in [0, {vocab})")
        if len(emitted) >= n_tokens:
            raise ResumeExhaustedError(
                f"{len(emitted)} tokens already emitted of a {n_tokens}-token budget")
        if any(t in set(eos) for t in emitted):
            raise ResumeExhaustedError("an EOS token was already emitted")
        samp["seed"] = int(rseed)
        resume_ids = [int(t) for t in emitted]
        resume_step = len(resume_ids)
        ids = list(ids) + resume_ids
        n_tokens -= resume_step
    server.stats["requests"] += 1
    # a stop sequence can straddle decode chunks ("hello wo" + "rld"): hold
    # back the longest prefix a stop could still complete
    reserve = max((len(s) for s in stops), default=1) - 1

    def events() -> Iterator[dict]:
        eos_set = set(eos)
        kw = deadline_kwargs(timeout_s, priority)
        if resume_step:
            kw["resume_step"] = resume_step
        gen = sset.stream_source(server, np.asarray([ids], np.int32), n_tokens,
                                 samp, stop_token_ids=list(eos) or None,
                                 request_id=request_id, timing=timing, **kw)
        try:
            # prime generation before yielding anything: a decode failure
            # must surface as a real status even for chat (whose first
            # event is the role chunk)
            first_piece = next(gen, None)
            yield from _sse_events(server, tok, chat, gen, first_piece, eos_set, stops,
                                   reserve, resume_ids, ids, include_usage, timing)
        finally:
            gen.close()

    return events()


def _sse_events(server, tok, chat, gen, first_piece, eos_set, stops, reserve,
                resume_ids, ids, include_usage, timing=None) -> Iterator[dict]:
    envelope = _envelope(OBJ_CHAT_CHUNK if chat else OBJ_COMPLETION, server.name)

    def content_event(delta: str) -> dict:
        choice = (
            {"index": 0, "delta": {"content": delta}, "finish_reason": None}
            if chat
            else {"index": 0, "text": delta, "finish_reason": None}
        )
        return {**envelope, "choices": [choice]}

    if chat:  # role announcement chunk (OpenAI contract)
        yield {
            **envelope,
            "choices": [{"index": 0, "delta": {"role": "assistant"}, "finish_reason": None}],
        }
    # a resumed stream's emitted tokens decoded to text already on the
    # severed stream's wire: only new text is emitted
    sent = tok.decode(resume_ids) if resume_ids else ""
    text = sent
    new_ids: list[int] = list(resume_ids)
    eos_count = 0
    finish = "length"
    pieces = gen if first_piece is None else itertools.chain((first_piece,), gen)
    for piece in pieces:
        piece_ids = piece[0].tolist()
        tcut = stop_cut(piece_ids, eos_set)
        hit_eos = tcut is not None
        if hit_eos:
            # usage counts the EOS; the content never includes it
            eos_count = 1
            piece_ids = piece_ids[: tcut - 1]
        new_ids.extend(piece_ids)
        # decode the full generated prefix each chunk and emit the tail:
        # per-chunk decode would split multi-token glyphs at chunk edges
        text = tok.decode(new_ids)
        cut, finish_now = apply_stop(text, stops)
        if finish_now == "stop":
            if cut[len(sent):]:
                yield content_event(cut[len(sent):])
            sent, finish = cut, "stop"
            break
        if not cut.startswith(sent):
            # an emitted prefix changed on re-decode (an incomplete glyph
            # slipped out): hold everything until the decode re-extends it
            if hit_eos:
                break  # the flush below emits the re-decoded remainder
            continue
        # trailing U+FFFD: the last glyph's bytes are still split across
        # tokens, so it is provisional
        stable = len(cut)
        while stable > len(sent) and cut[stable - 1] == "�":
            stable -= 1
        safe = max(len(sent), min(len(cut) - reserve, stable))
        if cut[len(sent):safe]:
            yield content_event(cut[len(sent):safe])
            sent = cut[:safe]
        if hit_eos:
            break  # the engine already stopped; flush the tail below
    if finish != "stop":
        if text.startswith(sent):
            if text[len(sent):]:
                yield content_event(text[len(sent):])  # flush the held tail
        elif text:
            # the final re-decode diverged from bytes already on the wire:
            # emit everything past the longest common prefix, so content
            # arrives complete
            lcp = 0
            for a, b in zip(sent, text):
                if a != b:
                    break
                lcp += 1
            if text[lcp:]:
                yield content_event(text[lcp:])
    if eos_count and finish == "length":
        finish = "stop"
    yield {
        **envelope,
        "choices": [
            {"index": 0, "delta": {}, "finish_reason": finish}
            if chat
            else {"index": 0, "text": "", "finish_reason": finish}
        ],
    }
    if include_usage:  # a final chunk with empty choices carrying the usage
        usage_event = {
            **envelope,
            "choices": [],
            "usage": {
                "prompt_tokens": len(ids),
                "completion_tokens": len(new_ids) + eos_count,
                "total_tokens": len(ids) + len(new_ids) + eos_count,
            },
        }
        if timing is not None:
            # close the source first so the engine's finally has filled the
            # breakdown even when a stop ended the loop early; engines
            # without phases leave it empty and the chunk unchanged
            gen.close()
            if timing:
                usage_event["timing"] = dict(timing)
        yield usage_event


def models_payload(sset) -> dict:
    """GET /v1/models body serving both contracts: the native {default,
    models} keys and OpenAI's {object: "list", data: [...]}.

    The model pool's set is reflected whole: every lifecycle entry appears
    with its state (a PULLING/LOADING model before it can serve, a FAILED
    one with its reason, an UNLOADED one as history), and the OpenAI
    ``data`` rows carry a ``lifecycle_state``. The prefix cache's stats are
    on ``/metrics`` and ``/admin/models``, as in the JAX sidecar."""
    pool = getattr(sset, "pool", None)
    lifecycle = pool.states() if pool is not None else {}
    models: dict = {}
    for n, s in list(sset.servers.items()):
        d = {"ready": s.ready, **s.stats}
        if s.load_error:
            d["error"] = s.load_error
        if n in lifecycle:
            d["lifecycle"] = lifecycle[n]
        models[n] = d
    for n, st in lifecycle.items():
        if n not in models:  # PULLING/FAILED-at-pull/UNLOADED: no server
            d = {"ready": False, "lifecycle": st}
            if st.get("error"):
                d["error"] = st["error"]
            models[n] = d
    return {
        "default": sset.default,
        "models": models,
        "object": "list",
        # OpenAI clients treat data rows as invokable: UNLOADED models stay
        # in the native ``models`` history but not here
        "data": [
            {"id": n, "object": "model", "created": 0, "owned_by": "modelx-tpu",
             **({"lifecycle_state": lifecycle[n]["state"]} if n in lifecycle else {})}
            for n in models
            if lifecycle.get(n, {}).get("state") != "UNLOADED"
        ],
    }


def sse_encode(event: dict) -> bytes:
    return b"data: " + json.dumps(event).encode() + b"\n\n"


SSE_DONE = b"data: [DONE]\n\n"
