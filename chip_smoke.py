#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``modelx_tpu_torch``).

    python3 chip_smoke.py                 # every phase, one H100
    python3 chip_smoke.py --phases kernels
    python3 chip_smoke.py --phases kernels,main,deploy,artifacts
    python3 chip_smoke.py --phases kernels,families
    python3 chip_smoke.py --phases kernels,train
    python3 chip_smoke.py --phases lockdep
    python3 chip_smoke.py --phases kernels,mesh

Phases, in order, each failing the run (exit code != 0) on any error:

1. device: the card's name and power limit;
2. build: every CUDA kernel of the serving and training paths, compiled
   from ``csrc/`` (one nvcc per source, all started together),
   with nvcc's register report and a SASS census (tensor-core and TMA
   instructions per kernel instantiation, from ``cuobjdump``), which fails
   unless each bf16 instantiation runs on the tensor cores it was written
   for (``check_census``: wgmma and TMA in the backward at head_dim
   64-128, mma.sync only at 32);
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes the serving path gives it, with stated tolerances and times
   (kernel back to back and as a lone call, plain version, PyTorch's
   library call as a yardstick, bound, achieved TFLOP/s); then the
   backward kernel at the training path's shapes (``BWD_CASES``): dq, dk,
   dv against ``attention_backward_reference`` (``BWD_TOL``), the training
   forward's o against ``attention_reference`` (``TOL``) and its row
   log-sum-exp against ``attention_lse_reference`` (``LSE_TOL``), timed
   back to back and lone, with the port's forward + backward, the plain
   version, the library's forward + backward and its backward alone (SDPA,
   or ``flex_attention`` with a softcap or a window) and the bound; at the
   training shape one ``torch.profiler`` capture splits the backward's
   device time by launch (pre-pass, main kernel, post-pass), printed with
   ptxas' registers and spills for each;
4. main: a full-width Llama-3-8B-shaped checkpoint (random weights from a
   seed) written with the port's safetensors writer, served by
   ``modelx_tpu_torch.dl.serve_main --prefix-cache 4`` on the card,
   answering ``/v1/forward`` and greedy ``/v1/generate``; the kernel's
   launch count must rise by ``num_layers`` per cache-free forward. Then
   sampled and streamed generation on the same server: seeded sampled
   requests repeat exactly, each ``top_k`` 1 token is a maximum of the
   logits on its own prefix (greedy's token or one tied with it), a near-flat
   ``top_p`` 0.99 nucleus takes the sampler's full-sort branch, NDJSON
   streams concatenate to the non-streamed tokens, a stop token ends a
   stream, a prompt that extends an earlier one hits the prefix cache and
   streams a cold run's tokens, and none of it launches the cache-free
   kernel. Then the observability surface of the same server (started with
   ``--access-log`` and ``--trace-dir`` in a temporary directory):
   ``/metrics`` counts every POST the phase sent and carries the card's
   measured memory, its Prometheus view parses line by line, a forward
   sent with ``X-ModelX-Request-Id`` gets it back with ``X-ModelX-Attempt``
   and ``/v1/trace?request_id=`` gives its ``serve.request`` and
   ``serve.request/serve.forward`` spans, ``/v1/profile`` (2 s) while two
   [1, 2048] forwards run writes a Chrome trace holding at least
   ``2 x num_layers`` flash-kernel events and as many cuBLAS GEMMs, six
   ``/admin/profile`` calls leave 4 capture dirs, the access log has one
   line per POST, and a span's host cost is timed. The sampler is held
   against its plain version on the card (fused == always-sort bytes at
   [4, vocab]; card draws == CPU draws) and timed, with device launches
   per sampled and greedy decode step.
5. text: the same server with a tokenizer.json of Llama-3's components
   (written here, 128,000 regular tokens and the 256 special ones) and
   Llama-3-Instruct's chat template: ``{"text": ...}`` on /v1/generate ==
   the token request, a greedy /v1/completions == that text, a chat
   rendered through the template (its ids hold ``<|start_header_id|>``),
   SSE deltas == the whole answer, a seeded sampled completion that
   repeats, a stop string that cuts, and ``logprobs`` scored by a
   cache-free forward: the kernel's launch count rises by ``num_layers``
   and its scores agree with the plain attention's within ``SCORE_TOL``.
   The kernel counts start at 0 again for this path.
6. options: the serving options on the same checkpoint, the kernel counts
   from 0 again. A ``dynamic_batch`` front over the loaded server takes 8
   forward, 4 greedy and 2 seeded sampled requests sent at once: they
   coalesce (fewer device calls than requests), forward groups launch the
   kernel ``num_layers`` times each, and every answer equals the same
   request sent alone to the server without the batcher, or differs only
   at tokens within ``OPTIONS_TIE_TOL`` of the maximum on their own prefix.
   ``--quantize int8``: codes and scales equal the host rule run on the
   same bf16 bytes, an int8 linear agrees with its dequantized fp32 product,
   ``/v1/forward`` runs the kernel. ``speculative_k`` 8 on a self-repeating
   prompt: greedy tokens equal plain greedy (or near-ties), the stream
   concatenates to the whole answer. ``--lora``: a PEFT adapter (r 16,
   alpha 32, q_proj and v_proj of every layer) written here is served, its
   merged weights equal a manual merge bit for bit, ``/v1/forward`` runs the
   kernel. One model at a time is loaded beside the main one, and the main
   one is freed before the LoRA server loads.
7. deploy: the registry deploy path, the earlier servers freed, the
   kernel counts from 0 again, on a second checkpoint that phases 7-9
   share: Llama-3-8B's widths at ``LATER_LAYERS`` (8) of its 32 layers
   (5.59 GB; for the run's time limit), its seeded weights written with
   the same text files, and the argmax of its served ``/v1/forward`` on
   the main phase's token rows taken before the phase. The checkpoint, its
   tokenizer.json and a modelx.yaml (``modelFiles`` naming the two) go
   into a local FS registry through the port's store API (the safetensors
   blob with the tensor-index annotation), the source checkpoint is
   deleted, and the port's registry serves them from a child process.
   ``modelxdl-torch REF DEST --device-put --blob-cache-dir D`` runs twice
   in child processes with ``MODELX_DL_NO_LOCAL_REDIRECT=1``: cold, the
   bytes come over HTTP and tee into the blob cache, every tensor put on
   the card equals dest's bytes; warm, the pull's hash-skip finds every
   file of dest at its digest and downloads nothing, and the load reads 0
   network bytes from the cache. The deploy TTFT
   (``modelx_tpu_torch.dl.ttft``) runs in fresh processes, cold and warm,
   its first token launching the kernel
   ``num_layers`` times; ``modelx-serve-torch --model m=DEST`` answers the
   main phase's ``/v1/forward`` rows with the source's argmax, and
   ``/healthz`` stays 200 through a registry kill with ``control_plane``
   no longer ok. Disk: the registry, dest and the blob cache each hold the
   checkpoint once; the phase checks for 3x that first.
8. artifacts: the derived-artifact stores (``dl/program_store.py``,
   ``dl/kv_store.py``, ``dl/outbox.py``) on the deploy phase's registry
   (restarted over its data) and warm blob cache, dest's weights moved aside
   for two staging copies (free disk checked first) and back after; the
   kernel counts are the two pods'. Each pod is a ``serve_main
   --allow-admin-load --continuous-batch --prefix-cache 4`` child booting a
   tiny GPT-2 (plain attention: nothing binds the kernel library before the
   admin load). (a) Pod A (``--publish-kv --kv-publish-threshold 2
   --publish-programs --publish-outbox-dir``) admin-loads the ref: the
   manifest gains a ``.programs-<env>.tar`` whose library hashes equal to
   the one phase 2 built; a 1,000-token base prompt and two branches off
   it make the base hot, and the manifest gains its ``.kv-<env>-<hash>.tar``,
   whose leaves are the layout (num_layers x K, V x [1, 1008, 8, 128] bf16).
   (b) Pod B, with ``MODELX_COMPILE_CACHE`` an empty directory, no nvcc in
   reach and ``--kv-fetch-through``, admin-loads the same ref: it installs
   the library (``kernel_library`` origin ``"bundle"``) and the KV bundle,
   its ``/v1/forward`` [1, 2048] equals the source's argmax, and a third
   branch, greedy and seeded sampled, whole and streamed, answers pod A's
   bytes from the installed prefix (``hits_installed``, the engine's
   installed admissions). (c) Pod A makes a second base hot; pod B's miss
   on it fetches the bundle through, and its next request hits it and
   answers pod A's tokens. Printed: bundle bytes, publish and install
   times, pod B's ready seconds against phase 2's nvcc seconds, the outbox
   depth while publishes land, and the first streamed token on the
   installed prefix against a prompt of the same length with none.
   (d) The router path: ``modelx_tpu_torch.router.router_main`` as a child
   process in front of pods A and B (no torch in its address space; its
   seconds to ``/healthz`` 200 and to both pods READY in ``/metrics``). A
   routed ``/v1/forward`` [1, 2048] equals the same body sent straight to
   the pod the router's ``routes`` name, byte for byte, and that pod's
   launches rise by one a layer (read through the child's SIGUSR1 line);
   the median of 5 routed and 5 direct forwards gives the hop's cost. Two
   greedy branches of a fresh 1,000-token base land on one pod
   (``sticky_hits`` rises) and equal its direct answers; a seeded NDJSON
   stream and an SSE ``/v1/completions`` equal the serving pod's direct
   answers (the SSE ``id``/``created`` the pod mints per request masked).
   A greedy 96-token stream through the router: after 8 tokens the phase
   SIGTERMs the pod feeding it, and the router hands the stream to the
   other pod (``drain_handoffs_total`` 1, ``streams_continued_total`` 1,
   ``severed_streams_total`` 0): 96 tokens and one done line, the head what
   the first pod relayed, the tail the second pod's direct answer to the
   same ``X-ModelX-Resume-*`` headers (``resume_step`` from its access
   log), the whole the uninterrupted answer or first different at a top-2
   margin within ``MARGIN_TOL`` (the plain path's logits, in process).
   With one pod left a forward still answers 200; after the second SIGTERM
   the typed 503 with ``Retry-After``. Its launches are counted apart
   (``launches_by_path.router``).
9. pool: the model pool (``dl/lifecycle.py``, ``dl/tiers.py``) on the
   pulled dest, once the deploy phase has freed its server, registry and
   blob cache; the kernel counts from 0 again. ``serve_main`` boots ``a``
   with ``--allow-admin-load --evict-idle``, a budget of 2.5x the
   checkpoint's bytes and host and disk tiers of 1.25x. (b) ``POST
   /admin/models`` loads ``b`` without waiting: meanwhile ``b`` answers 503
   + ``Retry-After`` on ``/v1/b/forward`` and, in the OpenAI shape, on chat,
   while ``a`` serves ``/v1/forward`` (timed against its lone time); then
   ``b``'s argmax equals ``a``'s. (c) Loading ``c`` evicts the least
   recently used idle model into the host tier. (d) Re-POSTing it promotes
   it from host (``load_source`` "tier", the same argmax). (e)
   ``spill_host()`` spools the tier to disk and the next re-POST promotes
   from disk; the pinned and pageable host-buffer rates are measured in
   the same call. (f) ``DELETE`` with a stream in flight: new requests 409,
   the stream ends whole and equal to the non-streamed answer, the last
   model refuses. (g) A ``serve_main`` child with ``--drain-grace 30`` gets
   SIGTERM mid-stream: ``/healthz`` 503 "draining" without
   ``Retry-After``, ``/livez`` 200, the stream whole, exit 0. (h) A pool
   with no budget admin-loads the checkpoint until a load is refused:
   devmem's measured veto (507) or a real out-of-memory error taking the
   shed-and-retry path; no load may end FAILED while a model could have
   been shed. Disk: the disk tier's spool beside dest (1.25x the
   checkpoint, checked first with MemAvailable).
10. continuous: the continuous engine (``dl/continuous.py``) on the main
   phase's checkpoint (all 32 layers), run right after phase 6 and before
   phase 7, the kernel counts from 0 again. Eight clients (prompts 128, 512
   and 1000 tokens + 64, odd ones seeded sampled, the last joining
   mid-decode) stream from a ``serve_main --continuous-batch --max-slots 8
   --prefix-cache 4`` child, then send the same requests whole: every
   answer equals the plain path's one request at a time, or each of its
   tokens lies within ``OPTIONS_TIE_TOL`` of the maximum on its own prefix
   (``check_near_ties``), and every stream equals its whole answer. A
   sampled stream cut after 10 tokens and resumed with ``resume`` continues
   it (the uninterrupted stream, or near-ties of the plain path); an expired
   ``X-ModelX-Deadline-Ms`` answers 504; a burst at ``--max-queue-depth 2``
   sheds 429 with ``Retry-After`` (the reference's status); ``/v1/forward``
   [1,2048] is timed while the rows decode and alone. In-process engines,
   one at a time: dense and paged gather at 32 slots (page 16, 32,768 live
   tokens) answer byte-equal, the dense engine again at pipeline and
   dispatch depth 1 byte-equal too, in-place equals gather or near-ties, a
   chunked prefill (``prefill_chunk`` 256) of the 1000-token prompt
   interleaves with decode rows without skipping a boundary, and
   ``speculative_k`` 8 on the options phase's self-repeating prompt equals
   plain greedy or near-ties, accepting as ``models/speculative.py``'s
   decoder does (its counts when the tokens agree, at least
   ``CONT_SPEC_MIN_RATE`` of the proposals otherwise). Admission and
   decode launch the flash kernel 0 times: the path's launches are the
   warm-ups and the forwards. Printed: tokens/s of the mix (engine, plain
   one at a time, ``--dynamic-batch``'s batcher, dense / gather / in-place
   engines), TTFT p50/p99 and the mid-decode join's, boundary host ms and
   blocking syncs per boundary, device operations and ms per chunk step,
   KV bytes dense against paged, and the longest gap between a decode
   row's tokens during the fill with chunked prefill and without.
11. families: the other generative families, one seeded random bf16
   checkpoint at a time, each written, served by ``serve_main`` and
   deleted before the next (free disk checked first; Mixtral's 6.33 GB
   is the peak), the kernel counts from 0 again: Gemma-2-9B cut to
   ``GEMMA_LAYERS`` of its 42 layers for the time limit (head_dim 256,
   softcap 50, window 4096 on the even layers), Phi-3-mini-4k cut to
   ``PHI3_LAYERS`` of its 32 (head_dim 96), Mixtral-8x7B cut to
   ``MIXTRAL_LAYERS`` of its 32 layers (all 32 take 93.4 GB), written in
   HF's per-expert layout so the loader folds the experts, and GPT-2 125M.
   For each: the inferred
   config equals the written one, ``/v1/forward`` [1, 2048] (gpt2: [1,
   1024]) launches the kernel once a layer (gpt2: never) and its argmax
   equals the plain attention's or each differing position is within
   ``OPTIONS_TIE_TOL`` of its maximum, greedy 128 + 32 runs, its NDJSON
   stream equals it, a seeded sampled request repeats. gemma2 and phi3
   are served with a tokenizer.json the phase writes beside them
   (``family_text``): a 256,000-piece Unigram file in the T5/XLM-R layout
   (``Precompiled`` charsmap, ``Metaspace``, a ``<s> $A </s>`` template,
   a truncation block) and a byte-level BPE file with ``Digits``,
   ``Punctuation`` and padding to a multiple of 8; each file's load and
   encode rate are timed, the ids of ``FAMILY_TEXTS`` must hash to
   ``FAMILY_TEXT_DIGESTS`` (the ``tokenizers`` package's ids, held by a
   CPU test), text on ``/v1/generate`` equals the token request, and
   gemma2's ``logprobs`` completion over the truncated prompt launches the
   kernel once a layer. gemma2 also: a [1,
   6144] forward past the window against the plain attention, a 4,500-token
   prompt + 16 greedy tokens through the windowed dense cache (each token
   within ``OPTIONS_TIE_TOL`` of a cache-free forward's maximum on its own
   prefix), a ``--continuous-batch --max-slots 4`` child answering 4
   clients and in-process gather and in-place paged engines (near-ties of
   the plain path). phi3: a ``--quantize int8`` server's forward. gpt2:
   prompts past ``n_positions`` answer the JAX sidecar's 400. Then
   BERT-base (0.44 GB fp32, as HF ships it): the inferred config equals
   the written one, ``/v1/forward`` [1, 512] and [8, 512] timed, its
   features at [1, 128] equal the port's fp32 forward on the CPU within
   ``BERT_FEATURE_TOL``, ``/v1/generate`` answers the JAX sidecar's 400, a
   513-token forward gpt2's 400 before any device work and a forward after
   it 200, and no flash launch (bert's attention is the plain reference).
   The objectstore path runs on phi3's checkpoint once phi3 is served
   (its own launch count from 0; alone: ``--phases kernels,objectstore``):
   the native IO engine builds (g++) and hashes the weights (the digest
   before the push), and the path fails if the engine is unavailable while
   g++ is on PATH; ``tests/fake_s3.py``'s bucket and the port's registry
   (``modelxd-torch --s3-url --enable-redirect --auth-token``) run as child
   processes; ``modelx-torch login`` and ``push`` upload the checkpoint
   through presigned multipart parts, the manifest carries the digest
   before the push, the bucket takes every byte and the registry answers
   no blob-content route for them (its request log, /metrics), a request
   without the token answers 401; the source is deleted and
   ``modelxdl-torch --device-put`` pulls it back through presigned ranged
   GETs (tensors on the device == the pulled file, the loader's native
   reads > 0), and hashlib hashes every pulled file to its digest; a second
   small repository takes ``modelx-torch gc --grace 0`` (its orphan goes,
   its referenced blobs stay) and ``scrub`` (clean, then a corrupted object
   quarantined, exit 1), the served repository ``scrub --sample 1``
   (clean); ``serve_main`` on the pulled copy answers the pre-push
   forward's argmax exactly with one launch a layer, and phi3's int8 check
   reads the pulled copy. Disk: the source is deleted before the pull, so
   the path writes one more copy of the checkpoint (2.21 GB at
   ``PHI3_LAYERS``), which sits beside the next family's (at most 6.33 GB);
   the bucket holds it in host memory.
12. train (alone: ``--phases kernels,train``; its launches counted from 0):
   (a) Llama-3-8B's widths at ``TRAIN_LAYERS`` (2) of 32 layers, bf16,
   written with the port's writer (2.97 GB), trained by
   ``modelx-train-torch --batch 1 --seq 2048 --steps 8`` in a child on a
   repeated batch: the loss is finite and falls, and the child launched
   the forward and the backward kernel once per layer per step; (b) in
   process, one step's gradients through the kernels against the plain
   attention's: every parameter has one, each within ``TRAIN_GRAD_TOL``
   relative L2, and the loss within ``TRAIN_LOSS_TOL`` relative; (c) ``--config tiny`` (head_dim 32) through the entry
   point: 4 steps with ``--checkpoint-dir``, a resume of 2 (steps reads 6)
   pushed to a ``modelxd-torch`` child over a temporary FS store, one more
   step pushed again (the blobs uploaded == the files that changed), and
   the unchanged checkpoint pushed again in process (none uploaded). The
   phase prints its
   wall, the bytes of the files it made (deleted at its end) and its peak
   device memory.
13. lockdep: the static analysis and runtime lock-order checking
   (``modelx_tpu_torch/analysis``), run right after pool on its dest (the
   later checkpoint, 8 of 32 layers), or alone (``--phases lockdep``) on
   that checkpoint written here; the kernel counts from 0 again. The lint
   gate (``python -m modelx_tpu_torch.analysis``) runs over the checkout
   and fails on a new finding or an unused baseline entry. Then the port's
   lockdep is installed and, after it (only locks made after the install
   are instrumented), a ``serve_main --continuous-batch --prefix-cache 4
   --allow-admin-load`` pod is built in process: a ``/v1/forward`` [1,
   2048] (the flash kernel once a layer; the argmax the later checkpoint's
   own serving gave), ``LOCKDEP_CLIENTS`` (8) concurrent clients each
   sending a streamed and a whole greedy ``/v1/generate`` (stream ==
   whole) while a second name of the same checkpoint is admin-loaded (its
   argmax == the first's), and unloaded, then a drain with a stream in
   flight (``/healthz`` 503, the stream whole). Lockdep is uninstalled and
   the phase fails on any lock-order cycle. Printed: the lock classes, the
   order edges, every class with a hold over ``LOCKDEP_HOLD_MS`` (its
   worst hold's ms and top frames), the longest hold, and the phase's
   flash launches. Long holds are reported, not failed.
14. mesh (alone: ``--phases kernels,mesh``; its launches counted from 0):
   Llama-3-8B's widths at ``MESH_LAYERS`` (2) of 32 layers (2.97 GB,
   written and deleted here), served across meshes of processes. (a) One
   rank over NCCL through ``modelx-serve-torch --mesh``, a child for each
   of ``MESH_A_RUNS`` (dp=1,tp=1 with the automatic attention; sp=1 with
   Ulysses; sp=1 with the ring): ``/v1/forward`` [1, 2048] equal bit for
   bit to the meshless server's (the ring's, whose merge is plain torch,
   each differing argmax within ``OPTIONS_TIE_TOL`` of the maximum), a
   32-token greedy ``/v1/generate`` equal, the mesh in the pod's log line
   and stats, and the flash kernel launched once a layer per cache-free
   forward (none on the ring). (b) Two ranks on the one card over gloo
   (NCCL refuses two ranks on one device; the smoke's choice, not the
   program's): each collective is probed on the card's tensors first, a
   refusal (only ``MESH_MAY_REFUSE``'s, with gloo's abort) printed on its
   own line and the ring's check left out; any other probe failure, or
   tp=2 or Ulysses left out, fails the phase. tp=2, Ulysses at sp=2 and
   the ring at sp=2 load their slices and run a [1, 512] forward whose
   logits must be within ``MESH_B_TOL`` of the meshless forward's (Ulysses
   bit for bit). The phase prints its seconds and bytes. What
   one card cannot show (NCCL across cards, the collectives' cost, tp=4/8
   at full depth) stays unverified.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the
``modelx_tpu_torch`` package beside this file, it exits non-zero and
prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CARD = "no card (CPU rehearsal)"  # nvidia-smi's name and power limit, once read
# POSTs this script sent, per server port: what a pod's /metrics requests
# and its access log must count
POSTS: dict[int, int] = {}

# H100 SXM published dense peaks (NVIDIA data sheet) at the 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# kernel in its working dtype vs the plain version in fp32, elementwise:
# |err| <= ATOL + RTOL * |ref|. bf16: the output is rounded to bf16 (half
# an ulp is 2^-9 relative) after an fp32 online softmax, so two bf16
# half-ulps plus a small absolute floor; fp32: reduction order only.
TOL = {"bfloat16": (2e-3, 8e-3), "float32": (2e-5, 2e-5)}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3, reps: int = 5) -> float:
    """Device time of one call: CUDA events around ``iters`` back-to-back
    calls, divided by ``iters``; the median of ``reps`` such runs, after
    warm-up. Back to back, the host's work to enqueue one call overlaps the
    device's work on the one before, as in a model's forward."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return statistics.median(runs)


def time_call_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Time of one call on its own: the median over ``iters`` calls of CUDA
    events around that single call, after warm-up. The device waits for the
    host to enqueue the call, so each sample holds the host's launch cost
    as well (``time_ms`` hides it behind the call before)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# -- phase 1: device -----------------------------------------------------------


def phase_device() -> dict:
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    global CARD
    CARD = card
    log(f"device: {name}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"count {torch.cuda.device_count()}")
    log(card)
    return {"name": name, "card": card}


# -- phase 2: build --------------------------------------------------------------

# SASS opcodes the census counts: Hopper's warpgroup MMA, the older warp
# MMA, TMA tile loads and cp.async copies
SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "LDGSTS")


def kernel_label(mangled: str) -> str:
    """``flash_fwd_bf16<128>`` for the mangled name of that instantiation
    (``flash_fwd_simt<bf16,32>`` with its element type, ``<128,lse>`` for
    the training forward's, ``flash_bwd_finish`` for a kernel that is no
    template), or the name itself when it is not one of ours."""
    m = re.search(r"(?<=\d)(flash_(?:fwd|bwd)_[a-z0-9_]+?)(?:I(f|13__nv_bfloat16)?Li(\d+)E"
                  r"(Lb1E)?|E)", mangled)
    if not m:
        return mangled
    if m.group(3) is None:
        return m.group(1)
    elem = {"f": "float,", "13__nv_bfloat16": "bf16,"}.get(m.group(2) or "", "")
    return f"{m.group(1)}<{elem}{m.group(3)}{',lse' if m.group(4) else ''}>"


def sass_census(sass: str) -> dict[str, dict[str, int]]:
    """Count ``SASS_OPS`` per kernel in ``cuobjdump --dump-sass`` output."""
    counts: dict[str, dict[str, int]] = {}
    cur = None
    op_re = re.compile(r"\b(" + "|".join(SASS_OPS) + r")\b")
    for line in sass.splitlines():
        fn = re.search(r"Function\s*:\s*(\S+)", line)
        if fn:
            cur = counts.setdefault(kernel_label(fn.group(1)), dict.fromkeys(SASS_OPS, 0))
            continue
        if cur is not None and "/*" in line:
            for op in op_re.findall(line):
                cur[op] += 1
    return counts


def dump_sass(nvcc: str, library: str) -> str | None:
    """``cuobjdump --dump-sass`` of ``library``, or None when the toolkit
    beside ``nvcc`` has no cuobjdump."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(tool):
        return None
    proc = subprocess.run([tool, "--dump-sass", library],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump exited {proc.returncode}\n{proc.stdout}")
    return proc.stdout


def phase_build() -> dict:
    """Build the kernels, print nvcc's register report and a SASS census of
    the library: per instantiation, the warpgroup MMAs (HGMMA), warp MMAs
    (HMMA), TMA tile loads (UTMALDG) and cp.async copies (LDGSTS). Fails
    where ``check_census`` finds a bf16 instantiation off the tensor cores
    it was written for."""
    import threading

    from modelx_tpu_torch import native
    from modelx_tpu_torch.kernels import build

    # the native IO engine (host C++, g++) builds beside nvcc, so the first
    # load does not wait for it
    native_s = {}

    def build_native():
        t = time.monotonic()
        native.build(force=True)
        native_s["s"] = time.monotonic() - t

    host = threading.Thread(target=build_native)
    host.start()
    t0 = time.monotonic()
    built = build.build()
    secs = time.monotonic() - t0
    host.join()
    log(f"build: flash_attention (forward and backward, one nvcc per source) "
        f"{'compiled by nvcc' if built else 'cached'} in {secs:.3f} s; "
        f"the native IO engine by g++ in {native_s['s']:.3f} s beside it "
        f"({'available' if native.available() else 'unavailable'})")
    notes = ("registers", "spill", "Compiling entry", "Performance Loss", "setmaxnreg", "rror",
             "arning")
    for line in build.build_log.splitlines():
        if any(w in line for w in notes):
            log(f"  nvcc: {line.strip()}")
    ptxas = ptxas_report(build.build_log)
    sass = dump_sass(build.nvcc_path(), build.library_path())
    if sass is None:
        log("sass census: not available (no cuobjdump beside nvcc)")
        return {"build_s": secs, "built": built, "sass": None, "ptxas": ptxas}
    census = sass_census(sass)
    for name, counts in sorted(census.items()):
        log(f"sass census: {name}: " + ", ".join(f"{op} {n}" for op, n in counts.items()))
    check_census(census)
    return {"build_s": secs, "built": built, "sass": census, "ptxas": ptxas}


def check_census(census: dict[str, dict[str, int]]) -> None:
    """Fail unless every bf16 instantiation runs on the tensor cores it was
    written for: the forward's (``flash_fwd_bf16<D>``, D != 32) HGMMA; the
    backward's wgmma kernel at D 64/96/128 (``flash_bwd_wgmma<D>``) HGMMA
    and UTMALDG and no HMMA; and HMMA only in the backward's head_dim 32
    pair (``flash_bwd_{dkdv,dq}_mma<32>``), the one mma.sync instantiation
    that stays."""
    from modelx_tpu_torch.ops.attention import BACKWARD_WGMMA_HEAD_DIMS, KERNEL_HEAD_DIMS

    want = [(f"flash_fwd_bf16<{d}>", "HGMMA") for d in KERNEL_HEAD_DIMS if d != 32]
    want += [(f"flash_bwd_wgmma<{d}>", op) for d in BACKWARD_WGMMA_HEAD_DIMS
             for op in ("HGMMA", "UTMALDG")]
    want += [(f"flash_bwd_{part}_mma<32>", "HMMA") for part in ("dkdv", "dq")]
    missing = [f"{name} {op}" for name, op in want if census.get(name, {}).get(op, 0) == 0]
    if missing:
        raise RuntimeError(f"no tensor-core or TMA instruction where one belongs: {missing}")
    stray = sorted(name for name, counts in census.items() if name.startswith("flash_bwd_")
                   and counts.get("HMMA", 0) and not name.endswith("_mma<32>"))
    stray += sorted(name for name in census
                    if re.fullmatch(r"flash_bwd_(dkdv|dq)_mma<\d+>", name)
                    and not name.endswith("<32>"))
    if stray:
        raise RuntimeError(f"mma.sync (HMMA) in a backward instantiation past head_dim 32: {stray}")


def ptxas_report(log: str) -> dict[str, dict[str, int]]:
    """Registers and spill bytes per kernel instantiation (``kernel_label``)
    from nvcc's ``-Xptxas -v`` output."""
    report: dict[str, dict[str, int]] = {}
    cur = None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            cur = report.setdefault(kernel_label(entry.group(1)), {})
            continue
        if cur is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            cur["spill_stores"], cur["spill_loads"] = int(spill.group(1)), int(spill.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            cur["registers"] = int(regs.group(1))
    return report


# -- phase 3: kernels against their plain versions ---------------------------------

# (label, B, H, Hkv, S, D, causal, scale, softcap, window, dtype)
ATTN_CASES = [
    ("llama3-8b prefill", 1, 32, 8, 2048, 128, True, None, 0.0, 0, "bfloat16"),
    ("batch 4x512", 4, 32, 8, 512, 128, True, None, 0.0, 0, "bfloat16"),
    ("non-causal", 2, 16, 16, 512, 128, False, None, 0.0, 0, "bfloat16"),
    ("head_dim 64", 2, 16, 4, 512, 64, True, None, 0.0, 0, "bfloat16"),
    ("gemma2 softcap+window", 1, 16, 8, 1024, 256, True, 256 ** -0.5, 50.0, 256, "bfloat16"),
    ("ragged S=1000", 2, 32, 8, 1000, 128, True, None, 0.0, 0, "bfloat16"),
    ("fp32 ragged S=333", 1, 8, 2, 333, 128, True, None, 0.0, 0, "float32"),
    ("phi3-mini prefill", 1, 32, 32, 2048, 96, True, None, 0.0, 0, "bfloat16"),
    ("fp32 head_dim 96 ragged S=333", 1, 8, 8, 333, 96, True, None, 0.0, 0, "float32"),
    ("gemma2-9b window", 1, 16, 8, 6144, 256, True, 256 ** -0.5, 50.0, 4096, "bfloat16"),
    ("tiny head_dim 32", 2, 4, 2, 256, 32, True, None, 0.0, 0, "bfloat16"),
    ("fp32 head_dim 32 ragged S=333", 1, 4, 2, 333, 32, True, None, 0.0, 0, "float32"),
]


def case_tensors(i: int):
    """q, k, v of ``ATTN_CASES[i]`` on the card, drawn from seed 1000 + i."""
    import torch

    _label, b, h, hkv, s, d, _causal, _scale, _cap, _window, dt = ATTN_CASES[i]
    gen = torch.Generator(device="cuda").manual_seed(1000 + i)
    return tuple(torch.randn(b, n, s, d, generator=gen, device="cuda").to(getattr(torch, dt))
                 for n in (h, hkv, hkv))


def visible_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask leaves visible for Sq == Sk == s."""
    if not causal:
        return s * s
    if window <= 0:
        return s * (s + 1) // 2
    return sum(min(window, i + 1) for i in range(s))


def attention_flops(b, h, s, d, causal, window) -> int:
    """4*D per visible (query, key) pair per head: QK^T and PV."""
    return 4 * d * visible_pairs(s, causal, window) * b * h


def attention_bound(b, h, hkv, s, d, causal, window, dtype) -> tuple[float, str]:
    """Least time in ms: max(bytes / HBM rate, FLOPs / peak rate for the
    dtype). FLOPs from ``attention_flops``; bytes = q, k, v read once (k/v
    at Hkv heads) and o written once."""
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = esize * b * s * d * (2 * h + 2 * hkv)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = attention_flops(b, h, s, d, causal, window) / PEAK_FLOPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def library_attention(q, k, v, ref, causal, scale, cap, window):
    """PyTorch's own call for the same function, as a yardstick only (the
    port never calls it): ``scaled_dot_product_attention`` (kv heads
    repeated outside the timed call), or, with a softcap or a window,
    ``flex_attention_call``. Returns (the call, its max abs error against
    ``ref``), or (None, None) when this torch has no such call."""
    import torch.nn.functional as F

    if cap == 0.0 and window == 0:
        rep = q.shape[1] // k.shape[1]
        kr, vr = (x.repeat_interleave(rep, dim=1) for x in (k, v))

        def call():
            return F.scaled_dot_product_attention(q, kr, vr, is_causal=causal, scale=scale)
    else:
        attend = flex_attention_call(causal, scale, cap, window, q.shape[2], k.shape[2])
        if attend is None:
            return None, None

        def call():
            return attend(q, k, v)
    err = float((call().float() - ref).abs().max())
    return call, err


def flex_attention_call(causal, scale, cap, window, sq, sk):
    """``flex_attention`` compiled with a tanh ``score_mod`` and a
    causal-window block mask, as a function of (q, k, v) (kv heads may be
    fewer), or None when this torch has no flex_attention."""
    import torch

    try:
        from torch.nn.attention.flex_attention import create_block_mask, flex_attention
    except ImportError:
        log(f"library: torch {torch.__version__} has no flex_attention")
        return None

    def score_mod(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap) if cap > 0.0 else score

    def mask_mod(b, h, qi, ki):
        seen = ki <= qi if causal else ki >= 0
        return seen & (qi - ki < window) if window > 0 else seen

    mask = create_block_mask(mask_mod, None, None, sq, sk, device="cuda")
    # the backward-alone yardstick runs the compiled backward again on one
    # graph (retain_graph), which a backward with donated buffers refuses
    torch._functorch.config.donated_buffer = False
    flex = torch.compile(flex_attention)

    def attend(q, k, v):
        return flex(q, k, v, score_mod=score_mod, block_mask=mask, scale=scale,
                    enable_gqa=True)
    return attend


def phase_kernels() -> list[dict]:
    import torch

    from modelx_tpu_torch.ops import attention as attn

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version is full fp32
    torch.backends.cudnn.allow_tf32 = False
    results = []
    failures = []
    for i, (label, b, h, hkv, s, d, causal, scale, cap, window, dt) in enumerate(ATTN_CASES):
        q, k, v = case_tensors(i)
        kw = dict(causal=causal, scale=scale, logit_softcap=cap, window=window)
        out = attn.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        ref = attn.attention_reference(q.float(), k.float(), v.float(), **kw)
        diff = (out.float() - ref).abs()
        atol, rtol = TOL[dt]
        max_err = float(diff.max())
        ok = bool(torch.isfinite(out).all()) and bool((diff <= atol + rtol * ref.abs()).all())
        library_call, library_err = library_attention(q, k, v, ref, causal, scale, cap, window)
        del ref, diff
        ms = time_ms(lambda: attn.flash_attention(q, k, v, **kw))
        call_ms = time_call_ms(lambda: attn.flash_attention(q, k, v, **kw))
        plain_ms = time_ms(lambda: attn.attention_reference(q, k, v, **kw), iters=5, reps=3)
        library_ms = time_ms(library_call) if library_call else None
        bound_ms, bound_by = attention_bound(b, h, hkv, s, d, causal, window, dt)
        tflops = attention_flops(b, h, s, d, causal, window) / (ms * 1e-3) / 1e12
        row = {
            "case": label, "shape": [b, h, s, d], "kv_heads": hkv, "dtype": dt,
            "causal": causal, "softcap": cap, "window": window,
            "max_abs_err": max_err, "tol": f"{atol} + {rtol}*|ref|", "ok": ok,
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_max_abs_err": library_err,
            "bound_ms": bound_ms, "bound_by": bound_by, "tflops": tflops,
        }
        results.append(row)
        log(f"kernel flash_attention [{label}] q{[b, h, s, d]} kv_heads {hkv} {dt}: "
            f"max_abs_err {max_err:.3e} (tol {atol} + {rtol}*|ref|) {'ok' if ok else 'FAIL'}; "
            f"kernel {ms:.4f} ms ({call_ms:.4f} ms a lone call), plain {plain_ms:.4f} ms, "
            f"library {'n/a' if library_ms is None else f'{library_ms:.4f} ms'} "
            f"(max_abs_err {library_err}), "
            f"bound {bound_ms * 1e3:.2f} us ({bound_by}), "
            f"{bound_ms / ms * 100:.1f}% of bound, {tflops:.1f} TFLOP/s")
        if not ok:
            failures.append(label)
    if failures:
        raise RuntimeError(f"flash_attention disagrees with its plain version: {failures}")
    return results


# (label, B, H, Hkv, S, D, causal, scale, softcap, window, dtype): the
# backward kernel at the training path's shapes and options
BWD_CASES = [
    ("llama3-8b training", 1, 32, 8, 2048, 128, True, None, 0.0, 0, "bfloat16"),
    ("head_dim 64 gqa", 2, 16, 4, 512, 64, True, None, 0.0, 0, "bfloat16"),
    ("softcap+window d128", 1, 16, 8, 1024, 128, True, 128 ** -0.5, 50.0, 256, "bfloat16"),
    ("fp32 ragged S=333", 1, 8, 2, 333, 128, True, None, 0.0, 0, "float32"),
    ("tiny head_dim 32", 2, 4, 2, 256, 32, True, None, 0.0, 0, "bfloat16"),
]
# gradients in the working dtype vs the plain version in fp32 on the same
# q, k, v, do and the forward kernel's o and lse, per tensor:
# |err| <= ATOL * max|ref| + RTOL * |ref|. bf16: dq, dk, dv are rounded to
# bf16 (half an ulp is 2^-9 relative) after fp32 sums; fp32: summation
# order only (in dS = P (dP - D) the two terms nearly cancel, so the floor
# is against the tensor's largest entry).
BWD_TOL = {"bfloat16": (2e-3, 8e-3), "float32": (1e-5, 2e-5)}
# the training forward's o is held to attention_reference under ``TOL``;
# the forward's row log-sum-exp against the plain fp32 one, absolute (log
# units: 1e-4 is a 1e-4 relative error in every P of the row)
LSE_TOL = 1e-4


def backward_flops(b, h, s, d, causal, window) -> int:
    """10*D per visible (query, key) pair per head: the five products
    S = QK^T, dP = dO V^T, dV = P^T dO, dQ = dS K, dK = dS^T Q."""
    return 10 * d * visible_pairs(s, causal, window) * b * h


def backward_bound(b, h, hkv, s, d, causal, window, dtype) -> tuple[float, str]:
    """Least time in ms of the backward: max(bytes / HBM rate, FLOPs / peak
    rate). Bytes: q, o, do read and dq written at H heads, k, v read and
    dk, dv written at Hkv heads, the fp32 lse read once."""
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = esize * b * s * d * (4 * h + 4 * hkv) + 4 * b * h * s
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = backward_flops(b, h, s, d, causal, window) / PEAK_FLOPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bwd_case_tensors(i: int):
    """q, k, v, do of ``BWD_CASES[i]`` on the card, drawn from seed 2000 + i."""
    import torch

    _label, b, h, hkv, s, d, _causal, _scale, _cap, _window, dt = BWD_CASES[i]
    gen = torch.Generator(device="cuda").manual_seed(2000 + i)
    return tuple(torch.randn(b, n, s, d, generator=gen, device="cuda").to(getattr(torch, dt))
                 for n in (h, hkv, hkv, h))


def library_attend(q, k, v, causal, scale, cap, window):
    """PyTorch's call for the same function as a function of leaves that
    require grad: (attend, leaves), kv heads repeated outside it for SDPA,
    or, with a softcap or a window, ``flex_attention_call``'s; None when
    this torch has no such call. A yardstick only: the port never calls it."""
    import torch.nn.functional as F

    if cap == 0.0 and window == 0:
        rep = q.shape[1] // k.shape[1]
        inputs = (q, k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1))

        def attend(q, k, v):
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal, scale=scale)
    else:
        inputs = (q, k, v)
        attend = flex_attention_call(causal, scale, cap, window, q.shape[2], k.shape[2])
        if attend is None:
            return None
    return attend, [x.detach().clone().requires_grad_(True) for x in inputs]


def library_forward_backward(q, k, v, do, causal, scale, cap, window):
    """The library's forward and backward on the same inputs through
    autograd (``library_attend``), or None."""
    import torch

    lib = library_attend(q, k, v, causal, scale, cap, window)
    if lib is None:
        return None
    attend, leaves = lib

    def call():
        return torch.autograd.grad(attend(*leaves), leaves, do)
    return call


def library_backward(q, k, v, do, causal, scale, cap, window):
    """The library's backward alone: one forward through autograd, then
    ``torch.autograd.grad(out, leaves, do, retain_graph=True)`` per call
    (``library_attend``), or None."""
    import torch

    lib = library_attend(q, k, v, causal, scale, cap, window)
    if lib is None:
        return None
    attend, leaves = lib
    out = attend(*leaves)

    def call():
        return torch.autograd.grad(out, leaves, do, retain_graph=True)
    return call


# back-to-back backward calls in the profiler capture of the training shape
BWD_PROFILE_CALLS = 5


def launch_split(fn, calls: int = BWD_PROFILE_CALLS) -> dict[str, dict]:
    """Device time of each kernel ``fn`` launches, from one ``torch.profiler``
    capture of ``calls`` back-to-back calls after a warm-up: per kernel
    (``flash_bwd_wgmma<128>``, or the profiler's name cut to 60 characters),
    its launches and ms a launch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # without it CUPTI stays subscribed after the window and every later
    # launch of the run pays for it
    os.environ.setdefault("TEARDOWN_CUPTI", "1")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split: dict[str, dict] = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        m = re.search(r"flash_(?:fwd|bwd)_\w+(<[^>(]*>)?", e.name)
        r = split.setdefault(m.group(0) if m else e.name[:60], {"launches": 0, "total_ms": 0.0})
        r["launches"] += 1
        r["total_ms"] += e.time_range.elapsed_us() / 1e3
    for r in split.values():
        r["ms"] = r["total_ms"] / r["launches"]
    if not split:
        raise RuntimeError("the profiler saw no kernel of the backward on the card")
    return split


def phase_backward(ptxas: dict | None = None) -> list[dict]:
    """The backward kernel against ``attention_backward_reference`` at each
    of ``BWD_CASES`` (and the training forward's o against
    ``attention_reference``, its lse against ``attention_lse_reference``),
    with its times: back to back and lone, the plain version's, the port's
    forward + backward through autograd, the library's forward + backward
    and its backward alone (SDPA, or ``flex_attention`` with a softcap or a
    window), and the bound. At the training shape, ``launch_split``: each
    launch's device time by kernel, with ptxas' registers and spills for
    it from ``ptxas`` (``ptxas_report`` of the build)."""
    import torch

    from modelx_tpu_torch.ops import attention as attn

    torch.backends.cuda.matmul.allow_tf32 = False
    rows, failures = [], []
    for i, (label, b, h, hkv, s, d, causal, scale, cap, window, dt) in enumerate(BWD_CASES):
        q, k, v, do = bwd_case_tensors(i)
        kw = dict(causal=causal, scale=scale, logit_softcap=cap, window=window)
        out, lse = attn._flash_cuda(q, k, v, causal, scale, cap, window, with_lse=True)
        dq, dk, dv = attn.flash_attention_backward(q, k, v, out, do, lse, **kw)
        torch.cuda.synchronize()
        ref_o = attn.attention_reference(q.float(), k.float(), v.float(), **kw)
        o_diff = (out.float() - ref_o).abs()
        o_err = float(o_diff.max())
        o_atol, o_rtol = TOL[dt]
        o_ok = bool(torch.isfinite(out).all()) and bool(
            (o_diff <= o_atol + o_rtol * ref_o.abs()).all())
        del ref_o, o_diff
        ref_lse = attn.attention_lse_reference(q.float(), k.float(), v.float(), **kw)
        lse_err = float((lse - ref_lse).abs().max())
        want = attn.attention_backward_reference(q.float(), k.float(), v.float(), out.float(),
                                                 do.float(), lse, **kw)
        atol, rtol = BWD_TOL[dt]
        errs, ok = {}, o_ok and lse_err <= LSE_TOL
        for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            diff = (got.float() - ref).abs()
            errs[name] = float(diff.max())
            ok = ok and bool(torch.isfinite(got).all()) and bool(
                (diff <= atol * ref.abs().max() + rtol * ref.abs()).all())
        del want, ref_lse
        ms = time_ms(lambda: attn.flash_attention_backward(q, k, v, out, do, lse, **kw),
                     iters=10, reps=3)
        call_ms = time_call_ms(
            lambda: attn.flash_attention_backward(q, k, v, out, do, lse, **kw), iters=10)
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        fwd_bwd_ms = time_ms(lambda: torch.autograd.grad(
            attn.flash_attention(*leaves, **kw), leaves, do), iters=10, reps=3)
        plain_ms = time_ms(lambda: attn.attention_backward_reference(
            q, k, v, out, do, lse, **kw), iters=3, reps=3)
        library_call = library_forward_backward(q, k, v, do, causal, scale, cap, window)
        library_ms = time_ms(library_call, iters=10, reps=3) if library_call else None
        library_bwd = library_backward(q, k, v, do, causal, scale, cap, window)
        library_bwd_ms = time_ms(library_bwd, iters=10, reps=3) if library_bwd else None
        bound_ms, bound_by = backward_bound(b, h, hkv, s, d, causal, window, dt)
        split = None
        if label == "llama3-8b training":
            split = launch_split(lambda: attn.flash_attention_backward(q, k, v, out, do, lse, **kw))
            for name, r in split.items():
                regs = (ptxas or {}).get(name, {})
                log(f"  launch split [{label}]: {name}: {r['launches']} launches, "
                    f"{r['ms']:.4f} ms a launch; ptxas: {regs.get('registers', 'n/a')} registers, "
                    f"{regs.get('spill_stores', 'n/a')} bytes spill stores, "
                    f"{regs.get('spill_loads', 'n/a')} bytes spill loads")
                r.update(regs)
        row = {
            "case": label, "shape": [b, h, s, d], "kv_heads": hkv, "dtype": dt,
            "causal": causal, "softcap": cap, "window": window,
            "max_abs_err": max(errs.values()), "errs": errs, "o_max_abs_err": o_err,
            "lse_max_abs_err": lse_err,
            "tol": f"{atol}*max|ref| + {rtol}*|ref|; o {o_atol} + {o_rtol}*|ref|; lse {LSE_TOL}",
            "ok": ok,
            "ms": ms, "call_ms": call_ms, "fwd_bwd_ms": fwd_bwd_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_bwd_ms": library_bwd_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "tflops": backward_flops(b, h, s, d, causal, window) / (ms * 1e-3) / 1e12,
            "launch_split": split,
        }
        rows.append(row)
        lib = "n/a" if library_ms is None else f"{library_ms:.4f} ms"
        lib_bwd = "n/a" if library_bwd_ms is None else f"{library_bwd_ms:.4f} ms"
        lib_name = "SDPA" if cap == 0.0 and window == 0 else "flex_attention"
        log(f"kernel flash_attention_backward [{label}] q{[b, h, s, d]} kv_heads {hkv} {dt}: "
            f"dq/dk/dv max_abs_err {errs['dq']:.3e}/{errs['dk']:.3e}/{errs['dv']:.3e}, "
            f"o {o_err:.3e}, lse {lse_err:.3e} (tol {row['tol']}) {'ok' if ok else 'FAIL'}; "
            f"backward {ms:.4f} ms ({call_ms:.4f} ms a lone call), forward+backward "
            f"{fwd_bwd_ms:.4f} ms, plain {plain_ms:.4f} ms, {lib_name} forward+backward {lib}, "
            f"{lib_name} backward alone {lib_bwd}, "
            f"bound {bound_ms * 1e3:.2f} us ({bound_by}), {bound_ms / ms * 100:.2f}% of bound, "
            f"{row['tflops']:.2f} TFLOP/s")
        if not ok:
            failures.append(label)
        del q, k, v, do, out, lse, dq, dk, dv, leaves, library_call, library_bwd
    if failures:
        raise RuntimeError(f"flash_attention_backward disagrees with its plain version: "
                           f"{failures}")
    return rows


# -- main --------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    known = ("kernels", "main") + LATER_PHASES + ("lockdep", "families", "objectstore", "train",
                                                  "mesh")
    ap.add_argument("--phases", default=",".join(known),
                    help="comma list of phases after device+build: kernels (the forward's "
                         "and the backward's cases), main (phases 4-6), deploy (7), artifacts "
                         "(8), pool (9), continuous (10), families (11; with the objectstore "
                         "path on phi3), objectstore (phi3 of phase 11 alone, with the path), "
                         "train (12), lockdep (13: right after pool when deploy runs, else "
                         "alone on a checkpoint it writes), mesh (14); continuous runs main "
                         "too, any of deploy..pool main and deploy")
    args = ap.parse_args(argv)
    phases = {p.strip() for p in args.phases.split(",") if p.strip()}
    if not phases <= set(known):
        ap.error(f"unknown phases {sorted(phases - set(known))}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke runs on the card only",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "modelx_tpu_torch")):
        print(f"chip_smoke: no modelx_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)

    t_run = time.monotonic()
    device = phase_device()
    build_info = phase_build()
    walls = {"build": time.monotonic() - t_run}

    def timed(name, fn):
        t0 = time.monotonic()
        out = fn()
        walls[name] = time.monotonic() - t0
        log(f"wall: the {name} phase{'s' if name == 'main' else ''} took {walls[name]:.1f} s "
            f"({time.monotonic() - t_run:.1f} s into the run)")
        return out

    kernel_rows = timed("kernels", phase_kernels) if "kernels" in phases else []
    bwd_rows = (timed("backward", lambda: phase_backward(build_info["ptxas"]))
                if "kernels" in phases else [])
    later = tuple(p for p in LATER_PHASES if p in phases)
    # the lockdep phase runs inside the deploy phase's hand-off, after pool,
    # on its dest; without deploy it writes the later checkpoint itself
    lockdep_in_main = "lockdep" in phases and bool(set(later) - {"continuous"})
    main_stats = (timed("main", lambda: phase_main(
        later=later, build_s=build_info["build_s"] if build_info["built"] else None,
        lockdep=lockdep_in_main))
        if phases & {"main", *LATER_PHASES} else {})
    if "lockdep" in phases and not lockdep_in_main:
        main_stats = {**main_stats, **timed("lockdep", lockdep_alone)}
    if "families" in phases:
        fam_stats = timed("families", phase_families)
    elif "objectstore" in phases:
        fam_stats = timed("families", lambda: phase_families(
            configs=[c for c in family_configs() if c[0] == "phi3"]))
    else:
        fam_stats = {}
    train_stats = timed("train", phase_train) if "train" in phases else {}
    mesh_stats = timed("mesh", phase_mesh) if "mesh" in phases else {}

    # each path's own count: every one starts at 0 just before its run
    by_path = {path: stats[key] for stats, path, key in (
        (main_stats, "main", "flash_launches"), (main_stats, "text", "flash_launches_text"),
        (main_stats, "options", "flash_launches_options"),
        (main_stats, "deploy", "flash_launches_deploy"),
        (main_stats, "artifacts", "flash_launches_artifacts"),
        (main_stats, "router", "flash_launches_router"),
        (main_stats, "pool", "flash_launches_pool"),
        (main_stats, "lockdep", "flash_launches_lockdep"),
        (main_stats, "continuous", "flash_launches_continuous"),
        (fam_stats, "families", "flash_launches_families"),
        (fam_stats, "objectstore", "flash_launches_objectstore"),
        (train_stats, "train", "train_fwd_launches"),
        (mesh_stats, "mesh", "flash_launches_mesh")) if key in stats}
    bwd_by_path = ({"train": train_stats["train_bwd_launches"]}
                   if "train_bwd_launches" in train_stats else {})
    head = next((r for r in kernel_rows if r["case"] == "llama3-8b prefill"), None)
    record = {
        "name": "flash_attention",
        "route": "cuda",
        "source": "modelx_tpu_torch/csrc/flash_attention.cu",
        "replaces": "modelx_tpu/ops/attention.py:149",
        # null, not 0, when no serving path ran (--phases kernels)
        "launches": sum(by_path.values()) if by_path else None,
        "launches_by_path": by_path,
        "max_abs_err": max((r["max_abs_err"] for r in kernel_rows), default=None),
        "ms": head and head["ms"],
        "call_ms": head and head["call_ms"],
        "plain_ms": head and head["plain_ms"],
        "bound_ms": head and head["bound_ms"],
        "bound_by": head and head["bound_by"],
        "library_ms": head and head["library_ms"],
        "tflops": head and head["tflops"],
        "at": "q [1,32,2048,128] bf16, 8 kv heads, causal",
        "build_s": build_info["build_s"],
        "built_by_nvcc": build_info["built"],
        "phase_walls_s": walls,
        "lockdep_phase_s": main_stats.get("lockdep_phase_s"),
        "sass": build_info["sass"],
        "cases": kernel_rows,
    }
    bhead = next((r for r in bwd_rows if r["case"] == "llama3-8b training"), None)
    bwd_record = {
        "name": "flash_attention_backward",
        "route": "cuda",
        "source": "modelx_tpu_torch/csrc/flash_attention_bwd.cu",
        # the TPU kernel whose gradient it is (JAX differentiates the Pallas call)
        "replaces": "modelx_tpu/ops/attention.py:149",
        "launches": sum(bwd_by_path.values()) if bwd_by_path else None,
        "launches_by_path": bwd_by_path,
        "max_abs_err": max((r["max_abs_err"] for r in bwd_rows), default=None),
        "ms": bhead and bhead["ms"],
        "call_ms": bhead and bhead["call_ms"],
        "fwd_bwd_ms": bhead and bhead["fwd_bwd_ms"],
        "plain_ms": bhead and bhead["plain_ms"],
        "bound_ms": bhead and bhead["bound_ms"],
        "bound_by": bhead and bhead["bound_by"],
        # SDPA's backward alone (and its forward + backward), a yardstick the
        # port never calls (each case's row holds its own: flex_attention's
        # with a softcap or window)
        "library_ms": bhead and bhead["library_bwd_ms"],
        "library_fwd_bwd_ms": bhead and bhead["library_ms"],
        "tflops": bhead and bhead["tflops"],
        "at": "q [1,32,2048,128] bf16, 8 kv heads, causal",
        "launch_split": bhead and bhead["launch_split"],
        "build_s": build_info["build_s"],
        "backward_phase_s": walls.get("backward"),
        "cases": bwd_rows,
    }
    log(device["card"])  # again at the end: a long run's output is read from its tail
    log(json.dumps({"kernels": [record, bwd_record]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["name"], "count": torch.cuda.device_count()}}))
    return 0


# -- phase 4: the serving path ---------------------------------------------------

MODEL = "llama3-8b"
FORWARD_SHAPES = ((1, 2048), (4, 512))
GENERATE_PROMPTS = (128, 512, 1000)  # prompt lengths, one row each
NEW_TOKENS = 32
# kernel-path and plain-path argmax must agree at every position whose
# top-2 logit margin (plain path, fp32) exceeds this: 4 bf16 ulps at the
# logits' magnitude (~4), the rounding the two bf16 paths may differ by
MARGIN_TOL = 0.125


def _http(port: int, path: str, body=None, timeout: float = 600.0):
    """(status, JSON body) of a GET, or of a POST of ``body``."""
    status, _, out = _http_full(port, "GET" if body is None else "POST", path, body, timeout)
    return status, out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _checkpoint_dir(nbytes: int) -> str:
    """The candidate directory (the temp dir, else the checkout) with the
    most free space; fails when even that cannot hold the checkpoint."""
    import shutil
    import tempfile

    cands = [tempfile.gettempdir(), REPO]
    free = {c: shutil.disk_usage(c).free for c in cands}
    best = max(cands, key=free.get)
    log(f"checkpoint dir candidates (free GB): "
        f"{ {c: round(f / 1e9, 1) for c, f in free.items()} }")
    if free[best] < 1.05 * nbytes:
        raise RuntimeError(f"no directory with {nbytes / 1e9:.1f} GB free for the checkpoint")
    return tempfile.mkdtemp(prefix="modelx-smoke-", dir=best)


LATER_PHASES = ("deploy", "artifacts", "pool", "continuous")
# the depth of the checkpoint deploy, artifacts and pool run on (Llama-3-8B's
# widths), for the run's time limit: their seconds follow its bytes. Phases
# 4-6 and the continuous engine keep all 32 layers: the exact sampled
# prefix-hit == cold check holds there (it failed at 24), and at 8 layers the
# random weights' speculation accept rate fell under CONT_SPEC_MIN_RATE.
LATER_LAYERS = 8


def later_checkpoint(cfg, device: str, forwards: dict) -> tuple:
    """(cfg, checkpoint dir, forwards) for phases 7-9: ``cfg`` cut to
    ``LATER_LAYERS`` layers, its seeded random weights written with the
    text files, and the argmax that serving it gives each of the main
    phase's ``/v1/forward`` token rows (``forwards`` maps shape to (tokens,
    argmax))."""
    import dataclasses
    import shutil

    import torch

    from modelx_tpu_torch.dl import safetensors as st
    from modelx_tpu_torch.dl import serve_main
    from modelx_tpu_torch.models import llama

    cut = dataclasses.replace(cfg, num_layers=min(cfg.num_layers, LATER_LAYERS))
    nbytes = 2 * sum(math.prod(s) for s in llama.param_shapes(cut).values())
    ckpt = _checkpoint_dir(nbytes)
    t0 = time.monotonic()
    try:
        gen = torch.Generator(device=device).manual_seed(0)
        params = llama.init_params(cut, gen, dtype=torch.bfloat16)
        st.write_safetensors(os.path.join(ckpt, "model.safetensors"), params)
        del params
        write_text_files(ckpt, cut.vocab_size - len(LLAMA3_SPECIALS))
        port = _free_port()
        sset, httpd = serve_main.start([
            "--model", f"{MODEL}={ckpt}", "--listen", f"127.0.0.1:{port}",
            "--device", device, "--dtype", "bfloat16"])
        out = {}
        try:
            for shape, (tokens, _) in forwards.items():
                status, body = _http(port, "/v1/forward", {"tokens": tokens.tolist()})
                if status != 200:
                    raise RuntimeError(f"later checkpoint: /v1/forward {shape} answered "
                                       f"{status} {body}")
                out[shape] = (tokens, torch.tensor(body["logits_argmax"]))
        finally:
            httpd.shutdown()
            httpd.server_close()
            _free(*sset.servers.values())
    except BaseException:
        shutil.rmtree(ckpt, ignore_errors=True)
        raise
    log(f"later phases: wrote a {cut.num_layers}-layer checkpoint at the same widths "
        f"({nbytes / 1e9:.3f} GB) and served its /v1/forward rows in "
        f"{time.monotonic() - t0:.1f} s")
    return cut, ckpt, out


def phase_main(device: str = "cuda", cfg=None, later=LATER_PHASES,
               build_s: float | None = None, lockdep: bool = True) -> dict:
    """Drive the serving path (phases 4-6), then those of ``later``: the
    continuous engine on the same checkpoint, then the rest on a shallower
    one (``later_checkpoint``), where deploy runs whenever any of them
    does, since the artifacts phase runs on its registry and the pool phase
    on its dest, and the lockdep phase (13) after pool on the same dest when
    ``lockdep``. ``build_s`` is phase 2's nvcc seconds (None: the library was
    cached). ``device="cpu"`` with a small ``cfg`` is a rehearsal of the
    control flow (the CPU tests run it): there the kernel wrapper runs its
    plain version and launches nothing."""
    import shutil

    import torch

    from modelx_tpu_torch.dl import safetensors as st
    from modelx_tpu_torch.dl import serve_main
    from modelx_tpu_torch.models import llama
    from modelx_tpu_torch.ops import attention as attn

    import tempfile

    on_card = device == "cuda"
    t_main = time.monotonic()
    # full width AND full depth
    cfg = cfg or llama.LlamaConfig.llama3_8b()
    nbytes = 2 * sum(math.prod(s) for s in llama.param_shapes(cfg).values())
    ckpt = _checkpoint_dir(nbytes)
    # the main server's access log and profiler captures
    obs_dir = tempfile.mkdtemp(prefix="modelx-smoke-obs-")
    stats: dict = {}
    httpd = None
    try:
        t0 = time.monotonic()
        gen = torch.Generator(device=device).manual_seed(0)
        params = llama.init_params(cfg, gen, dtype=torch.bfloat16)
        st.write_safetensors(os.path.join(ckpt, "model.safetensors"), params)
        del params
        write_text_files(ckpt, cfg.vocab_size - len(LLAMA3_SPECIALS))
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        log(f"main: wrote a seeded random Llama-3-8B-shaped checkpoint ({cfg.num_layers} "
            f"layers, hidden {cfg.hidden_size}, ffn {cfg.intermediate_size}, heads "
            f"{cfg.num_heads}/{cfg.num_kv_heads}, vocab {cfg.vocab_size}, bf16, "
            f"{nbytes / 1e9:.3f} GB) in {time.monotonic() - t0:.1f} s")

        # the main path: every kernel count starts at 0 here
        attn.flash_attention.launches = 0
        per_forward = cfg.num_layers if on_card else 0
        port = _free_port()
        t0 = time.monotonic()
        sset, httpd = serve_main.start([
            "--model", f"{MODEL}={ckpt}", "--listen", f"127.0.0.1:{port}",
            "--device", device, "--dtype", "bfloat16", "--max-seq-len", "2048",
            "--prefix-cache", "4", "--access-log", os.path.join(obs_dir, "access.jsonl"),
            "--trace-dir", os.path.join(obs_dir, "trace")])
        start_s = time.monotonic() - t0
        status, body = _http(port, "/healthz")
        if status != 200:
            raise RuntimeError(f"/healthz answered {status} {body}")
        server = sset.servers[MODEL]
        if server.cfg.num_layers != cfg.num_layers or server.cfg.vocab_size != cfg.vocab_size:
            raise RuntimeError(f"inferred config {server.cfg} does not match {cfg}")
        s = server.stats
        log(f"main: serve_main up in {start_s:.2f} s; load {s['load_seconds']} s, "
            f"{s['load_bytes'] / 1e9:.3f} GB at {s['load_gbps']} GB/s, ready "
            f"{s['ready_seconds']} s (includes one warm-up forward)")
        stats.update(load_seconds=s["load_seconds"], load_gbps=s["load_gbps"])

        rng = torch.Generator().manual_seed(1)
        forwards = {}
        greedy = {}
        for shape, rep in ((sh, r) for sh in FORWARD_SHAPES for r in range(2)):
            if rep == 0:
                tokens = torch.randint(0, cfg.vocab_size, shape, generator=rng)
            before = attn.flash_attention.launches
            t0 = time.monotonic()
            status, body = _http(port, "/v1/forward", {"tokens": tokens.tolist()})
            ms = (time.monotonic() - t0) * 1e3
            if status != 200:
                raise RuntimeError(f"/v1/forward {shape} answered {status} {body}")
            got = torch.tensor(body["logits_argmax"])
            if tuple(got.shape) != shape or int(got.min()) < 0 or int(got.max()) >= cfg.vocab_size:
                raise RuntimeError(f"/v1/forward {shape}: bad logits_argmax shape {tuple(got.shape)}")
            rose = attn.flash_attention.launches - before
            if rose != per_forward:
                raise RuntimeError(f"/v1/forward {shape}: flash_attention launched {rose} "
                                   f"times, want {per_forward} (one per layer on the card)")
            if rep and not torch.equal(got, forwards[shape][1]):
                raise RuntimeError(f"/v1/forward {shape}: a repeated request answered differently")
            forwards[shape] = (tokens, got)
            log(f"main: /v1/forward {list(shape)} ({'repeat' if rep else 'first'}): 200 in "
                f"{ms:.1f} ms; flash_attention launches +{rose}")
            stats[f"forward_ms_{shape[0]}x{shape[1]}" + ("" if rep else "_first")] = ms

        for plen in GENERATE_PROMPTS:
            prompt = torch.randint(0, cfg.vocab_size, (1, plen), generator=rng)
            before = attn.flash_attention.launches
            t0 = time.monotonic()
            status, body = _http(port, "/v1/generate",
                                 {"tokens": prompt.tolist(), "max_new_tokens": NEW_TOKENS})
            secs = time.monotonic() - t0
            if status != 200:
                raise RuntimeError(f"/v1/generate prompt {plen} answered {status} {body}")
            out = torch.tensor(body["tokens"])
            if tuple(out.shape) != (1, plen + NEW_TOKENS) or not torch.equal(out[:, :plen], prompt):
                raise RuntimeError(f"/v1/generate prompt {plen}: bad tokens shape {tuple(out.shape)}")
            if int(out.max()) >= cfg.vocab_size or attn.flash_attention.launches != before:
                raise RuntimeError("/v1/generate: token out of vocab, or the cached path "
                                   "launched the cache-free kernel")
            log(f"main: /v1/generate prompt {plen} + {NEW_TOKENS} greedy: 200 in {secs:.3f} s, "
                f"{NEW_TOKENS / secs:.1f} tokens/s (prefill included)")
            stats[f"generate_s_{plen}"] = secs
            greedy[plen] = (prompt[0].tolist(), out[0, plen:].tolist())
        before = attn.flash_attention.launches
        stats.update(phase_sampling(port, server, cfg, greedy))
        if attn.flash_attention.launches != before:
            raise RuntimeError("sampled or streamed generation launched the cache-free kernel")
        # the observability surface on the same server (its profile window's
        # forwards count on the main path)
        stats.update(phase_observability(port, sset, cfg, obs_dir, per_forward, on_card))
        stats["flash_launches"] = attn.flash_attention.launches
        log(f"main: flash_attention launches on the main path: {stats['flash_launches']}")

        # the text path (phase 5): every kernel count starts at 0 again
        attn.flash_attention.launches = 0
        stats.update(phase_text(port, server, cfg, per_forward))
        log(f"text: flash_attention launches on the text path: {stats['flash_launches_text']}")

        # outside the counted runs: the sampler against its plain versions,
        # then its costs (its torch.profiler traces come last: the objects
        # they leave make the next garbage collection a long one)
        stats.update(check_sampler(server, cfg, on_card))
        if on_card:
            stats["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
            log(f"main: torch.cuda.max_memory_allocated "
                f"{stats['max_memory_allocated_gb']:.3f} GB")

        # outside the counted run: the kernel path against the plain path in-process
        tokens, http_argmax = forwards[FORWARD_SHAPES[0]]
        with torch.inference_mode():
            tok = tokens.to(device)
            flash = llama.forward(server.params, tok, server.cfg)[0].float()
            plain = llama.forward(server.params, tok, server.cfg, attention_impl="reference")[0]
            plain = plain.float()
        am_flash = flash.argmax(-1).cpu()
        if not torch.equal(am_flash, http_argmax):
            raise RuntimeError("in-process kernel-path argmax differs from /v1/forward's")
        top2 = plain.topk(2, dim=-1).values
        margin = (top2[..., 0] - top2[..., 1]).cpu()
        clear = margin > MARGIN_TOL
        agree = am_flash == plain.argmax(-1).cpu()
        max_diff = float((flash - plain).abs().max())
        n_clear, n_bad = int(clear.sum()), int((clear & ~agree).sum())
        log(f"main: kernel vs plain path on {list(tokens.shape)}: max |logit diff| "
            f"{max_diff:.4f} (logit max {float(plain.abs().max()):.2f}); argmax agrees at "
            f"{int(agree.sum())}/{agree.numel()} positions, at {n_clear - n_bad}/{n_clear} "
            f"whose top-2 margin > {MARGIN_TOL}")
        if n_bad or n_clear == 0:
            raise RuntimeError("kernel-path argmax disagrees with the plain path")
        if not (torch.isfinite(flash).all() and torch.isfinite(plain).all()):
            raise RuntimeError("non-finite logits")
        stats.update(logit_max_diff=max_diff, argmax_checked=n_clear)
        del flash, plain  # 2.1 GB of fp32 logits the next phase does not need

        # phase 6, the serving options: every kernel count starts at 0 again
        attn.flash_attention.launches = 0
        stats.update(phase_options(port, server, cfg, ckpt, per_forward, stats))
        log(f"options: flash_attention launches on the options path: "
            f"{stats['flash_launches_options']}")

        httpd.shutdown()
        httpd.server_close()
        httpd = None
        stats["main_4_6_s"] = time.monotonic() - t_main
        log(f"wall: phases 4-6 (main, text, options) took {stats['main_4_6_s']:.1f} s")
        if "continuous" in later:
            # phase 10, the continuous engine, on this full-depth checkpoint
            # (its child's log in obs_dir): its own count from 0
            t0 = time.monotonic()
            stats.update(phase_continuous(cfg, ckpt, device, obs_dir))
            stats["cont_phase_s"] = time.monotonic() - t0
            log(f"continuous: flash_attention launches on the continuous path: "
                f"{stats['flash_launches_continuous']} (warm-ups and /v1/forward only); the "
                f"phase took {stats['cont_phase_s']:.1f} s")
        if not set(later) - {"continuous"}:
            return stats
        # phases 7-9 on a second checkpoint: the same widths, LATER_LAYERS deep
        shutil.rmtree(ckpt, ignore_errors=True)
        cfg, ckpt, forwards = later_checkpoint(cfg, device, forwards)
        per_forward = cfg.num_layers if on_card else 0
        stats["later_layers"] = cfg.num_layers
        # phase 7, the registry deploy, with the earlier servers freed: its
        # own count (the served dest's from 0, plus its TTFT children's)
        attn.flash_attention.launches = 0
        # phase 8, the derived-artifact stores, on the deploy's registry data
        # and warm blob cache (its count: its two pods'); then phase 9, the
        # model pool, on the pulled dest once the registry and blob cache are
        # gone: each its own count

        def artifacts(reg_dir, cache, dest, root, digest):
            t0 = time.monotonic()
            out = phase_artifacts(cfg, reg_dir, cache, dest, root, digest, forwards, device,
                                  per_forward, build_s)
            out["art_phase_s"] = time.monotonic() - t0
            log(f"artifacts: flash_attention launches on the artifacts path: "
                f"{out['flash_launches_artifacts']} (pods A and B: the admin load's warm-up "
                f"and one /v1/forward each), on the router path: "
                f"{out['flash_launches_router']}; the phase took {out['art_phase_s']:.1f} s")
            return out

        def pool(dest, root):
            out = {}
            if "pool" in later:
                t0 = time.monotonic()
                out.update(phase_pool(cfg, dest, forwards, device, root))
                out["pool_phase_s"] = time.monotonic() - t0
                log(f"pool: flash_attention launches on the pool path: "
                    f"{out['flash_launches_pool']}; the phase took {out['pool_phase_s']:.1f} s")
            if lockdep:
                # phase 13, on the same dest: its own count from 0
                out.update(phase_lockdep(cfg, dest, device, forwards))
                log(f"lockdep: flash_attention launches on the lockdep path: "
                    f"{out['flash_launches_lockdep']}")
            return out

        stats.update(phase_deploy(
            cfg, ckpt, forwards, device, per_forward,
            artifacts=artifacts if "artifacts" in later else None,
            then=pool if "pool" in later or lockdep else None))
        log(f"deploy: flash_attention launches on the deploy path: "
            f"{stats['flash_launches_deploy']} ({stats['flash_launches_deploy_serve']} serving "
            f"dest, {per_forward} in each TTFT process)")
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        shutil.rmtree(ckpt, ignore_errors=True)
        shutil.rmtree(obs_dir, ignore_errors=True)
    return stats


# -- phase 4, continued: sampled and streamed generation ------------------------------

SAMPLED = {"temperature": 0.8, "top_k": 40, "top_p": 0.95, "seed": 7}
# a near-flat random-weight distribution: the 0.99 nucleus overflows K_CAP
OVERFLOW = {"temperature": 1.0, "top_k": 0, "top_p": 0.99, "seed": 3}
# sample() on the card against the CPU: a token may differ only where the
# top two perturbed logits lie this close (float32 rounding of the inputs;
# the draws themselves must be bit-equal)
NEAR_TIE = 1e-5


def _stream(port: int, body: dict, timeout: float = 600.0):
    """POST a streamed /v1/generate; (tokens, seconds to the first line,
    seconds in all). Fails on a non-200, an error line or a missing done."""
    import urllib.request

    POSTS[port] = POSTS.get(port, 0) + 1
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/generate",
                                 data=json.dumps({**body, "stream": True}).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    first = None
    lines = []
    with urllib.request.urlopen(req, timeout=timeout) as r:
        if r.status != 200:
            raise RuntimeError(f"stream answered {r.status}")
        for raw in r:
            first = first if first is not None else time.monotonic() - t0
            lines.append(json.loads(raw))
    total = time.monotonic() - t0
    if not lines or lines[-1] != {"done": True} or any("error" in x for x in lines):
        raise RuntimeError(f"bad stream: {lines[-3:]}")
    return [t for x in lines[:-1] for t in x["tokens"][0]], first, total


def _sampled(port: int, body: dict, plen: int, n: int):
    """A non-streamed /v1/generate; (new tokens, seconds, sort-branch steps)."""
    from modelx_tpu_torch.ops import sampling

    sorts = sampling.scale_and_filter.sorts
    t0 = time.monotonic()
    status, out = _http(port, "/v1/generate", body)
    secs = time.monotonic() - t0
    if status != 200 or len(out["tokens"][0]) != plen + n:
        raise RuntimeError(f"sampled /v1/generate answered {status} {str(out)[:200]}")
    return out["tokens"][0][plen:], secs, sampling.scale_and_filter.sorts - sorts


def _replay_step_logits(server, prompt: list, forced: list):
    """Replay the server's decode of ``prompt`` in-process (the padded
    shapes /v1/generate runs), feeding ``forced`` as the tokens: step j
    sees ``forced[:j]``. Returns (greedy's pick at each step, the float32
    logits each step picked from, [len(forced), V])."""
    import torch

    from modelx_tpu_torch.models import decode

    fwd, init = server.family.decode_fns(server.params, server.cfg)
    rows = []

    def forcing(p, t, kv_cache, cache_offset):
        if t.shape[1] == 1:  # a decode step: feed the forced token of the last step
            t = torch.full_like(t, forced[len(rows) - 1])
        logits, cache = fwd(p, t, kv_cache=kv_cache, cache_offset=cache_offset)
        rows.append(logits[0, len(prompt) - 1 if t.shape[1] > 1 else -1].float())
        return logits, cache

    padded = torch.zeros((1, decode.pad_seq_len(len(prompt))), dtype=torch.int64)
    padded[0, : len(prompt)] = torch.tensor(prompt)
    with torch.inference_mode():
        picks = decode.ragged_greedy_generate(forcing, init, server.params,
                                              padded.to(server.device), [len(prompt)],
                                              len(forced))
    return picks[0].tolist(), torch.stack(rows)


def _check_top1(server, prompt: list, greedy_new: list, top1: list) -> str:
    """``top_k`` 1 keeps every token tied at the top logit (the reference's
    ">= the k-th value" rule), so each of its tokens must be a maximum of
    the logits on its own prefix: greedy's token, or another one tied with
    it. The replay feeds top_k 1's tokens and checks every step."""
    if top1 == greedy_new:
        return "top_k 1 == greedy"
    if len(top1) != len(greedy_new):
        raise RuntimeError(f"top_k 1 gave {len(top1)} tokens, greedy {len(greedy_new)}")
    picks, logits = _replay_step_logits(server, prompt, top1)
    j0 = next(i for i, (a, b) in enumerate(zip(top1, greedy_new)) if a != b)
    if picks[: j0 + 1] != greedy_new[: j0 + 1]:
        raise RuntimeError("the in-process replay differs from greedy /v1/generate")
    ties = []
    for j, tok in enumerate(top1):
        tied = (logits[j] == logits[j].max()).nonzero()[:, 0].tolist()
        if tok not in tied:
            raise RuntimeError(f"top_k 1 drew token {tok} at step {j}, below the maximum "
                               f"(greedy there: {picks[j]})")
        if tok != picks[j]:
            ties.append(f"{j} ({len(tied)} tied)")
    return (f"top_k 1 == greedy up to step {j0}; each of its {len(top1)} tokens is a "
            f"maximum on its own prefix, drawn among tied tokens at steps {', '.join(ties)}")


def phase_sampling(port: int, server, cfg, greedy: dict) -> dict:
    """Sampled and streamed generation on the running server. ``greedy``
    maps each prompt length to (prompt, greedy new tokens) from the greedy
    requests."""
    from modelx_tpu_torch.models.decode import stop_cut

    stats: dict = {}
    n = NEW_TOKENS
    for plen, (prompt, greedy_new) in greedy.items():
        body = {"tokens": [prompt], "max_new_tokens": n, **SAMPLED}
        toks, secs, sorts = _sampled(port, body, plen, n)
        again, secs2, _ = _sampled(port, body, plen, n)
        if again != toks:
            raise RuntimeError(f"sampled prompt {plen}: the same request answered differently")
        streamed, first_s, total_s = _stream(port, body)
        if streamed != toks:
            raise RuntimeError(f"sampled prompt {plen}: the stream's tokens differ from "
                               f"/v1/generate's")
        top1, _, _ = _sampled(port, {**body, "top_k": 1}, plen, n)
        top1_note = _check_top1(server, prompt, greedy_new, top1)
        rate = n / min(secs, secs2)
        stream_rate = (n - 1) / max(total_s - first_s, 1e-9)
        log(f"sampling: prompt {plen} + {n} {SAMPLED}: 200 in {secs:.3f} / {secs2:.3f} s, "
            f"{rate:.1f} tokens/s (prefill included), identical twice; sampler branch: "
            f"{n - sorts} fused, {sorts} full-sort steps; stream equal, first line "
            f"{first_s * 1e3:.1f} ms, {stream_rate:.1f} tokens/s after it, "
            f"{n / total_s:.1f} in all; {top1_note}")
        stats.update({f"sampled_tokens_per_s_{plen}": rate,
                      f"stream_first_line_ms_{plen}": first_s * 1e3,
                      f"stream_tokens_per_s_{plen}": stream_rate,
                      f"sampled_sort_steps_{plen}": sorts})

    plen, (prompt, greedy_new) = next(iter(greedy.items()))
    body = {"tokens": [prompt], "max_new_tokens": n, **OVERFLOW}
    toks, secs, sorts = _sampled(port, body, plen, n)
    log(f"sampling: prompt {plen} {OVERFLOW}: sampler branch {n - sorts} fused, "
        f"{sorts} full-sort steps, {n / secs:.1f} tokens/s")
    if sorts == 0:
        raise RuntimeError("the top_p 0.99 request never took the full-sort branch")
    if _stream(port, body)[0] != toks:
        raise RuntimeError("the overflowing request's stream differs from /v1/generate")
    stats["overflow_sort_steps"] = sorts

    zero = _stream(port, {"tokens": [prompt], "max_new_tokens": n})[0]
    if zero != greedy_new:
        raise RuntimeError("a temperature 0 stream differs from greedy /v1/generate")
    stop = toks[n // 2]
    stopped = _stream(port, {**body, "stop_token_ids": [stop]})[0]
    if stopped != toks[: stop_cut(toks, {stop})]:
        raise RuntimeError(f"the stream with stop token {stop} did not end at it")
    log(f"sampling: temperature 0 stream == greedy; stop token {stop} ended the stream "
        f"after {len(stopped)} of {n} tokens")

    # prefix cache: turn 2 extends turn 1; its stream must hit and equal a cold run
    pc = server._prefix_cache
    body = {"tokens": [prompt], "max_new_tokens": n, **SAMPLED}
    out1 = _stream(port, body)[0]
    turn2 = {**body, "tokens": [prompt + out1 + [7]]}
    hits = pc.stats()["hits"]
    warm, first_warm, _ = _stream(port, turn2)
    if pc.stats()["hits"] != hits + 1:
        raise RuntimeError(f"turn 2 did not hit the prefix cache: {pc.stats()}")
    pc.clear()
    misses = pc.stats()["misses"]
    cold, first_cold, _ = _stream(port, turn2)
    if pc.stats()["misses"] != misses + 1 or warm != cold:
        raise RuntimeError("the prefix-cache hit's tokens differ from a cleared cache's")
    log(f"sampling: prefix cache hit on a {len(turn2['tokens'][0])}-token turn 2 streams the "
        f"cold run's tokens; first line {first_warm * 1e3:.1f} ms warm, "
        f"{first_cold * 1e3:.1f} ms cold; stats {pc.stats()}")
    stats.update(prefix_first_line_ms_warm=first_warm * 1e3,
                 prefix_first_line_ms_cold=first_cold * 1e3)
    return stats


# -- phase 4, continued: the observability surface ------------------------------------

PROFILE_SECONDS = 2.0
PROFILE_FORWARD = (1, 2048)
ADMIN_PROFILES = 6
ADMIN_PROFILE_SECONDS = 0.2
# the cuBLAS GEMM kernels' names on Hopper (cuBLAS's own sm90 kernels, its
# nvjet kernels, CUTLASS-generated ones)
GEMM_NAME = re.compile(r"gemm|nvjet|cutlass|xmma", re.IGNORECASE)
_PROM_SAMPLE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="'
                          r'(\\.|[^"\\])*",?)*\})? (\S+)$')


def check_prometheus(text: str) -> int:
    """Every line of a text exposition is a ``# HELP``, a ``# TYPE`` or a
    valid sample with a float value; returns the sample count."""
    samples = 0
    for line in text.splitlines():
        if line.startswith(("# HELP ", "# TYPE ")):
            continue
        m = _PROM_SAMPLE.match(line)
        if m is None:
            raise RuntimeError(f"observability: unparseable /metrics line {line!r}")
        float(m.group(4))
        samples += 1
    return samples


def trace_kernels(path: str) -> dict[str, int]:
    """Kernel events of a ``torch.profiler`` Chrome trace by name."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    counts: dict[str, int] = {}
    for e in events:
        if e.get("cat") == "kernel":
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    return counts


def phase_observability(port: int, sset, cfg, obs_dir: str, per_forward: int,
                        on_card: bool) -> dict:
    """The main server's observability surface, after the main path's
    requests: ``/metrics`` counts every POST sent (JSON) and parses as
    Prometheus text, with the card's measured memory; a forward sent with
    ``X-ModelX-Request-Id`` gets it and ``X-ModelX-Attempt`` back, and
    ``/v1/trace?request_id=`` gives its two spans; ``/v1/profile`` while two
    [1, 2048] forwards run captures the flash kernel and the cuBLAS GEMMs
    on the card; six ``/admin/profile`` calls leave 4 capture dirs; the
    access log has one line per POST. Times the host cost of a span."""
    import threading

    import torch

    from modelx_tpu_torch.ops import attention as attn
    from modelx_tpu_torch.utils import trace

    stats: dict = {}
    status, metrics = _http(port, "/metrics")
    want = POSTS.get(port, 0)
    if status != 200 or metrics[MODEL]["requests"] != want:
        raise RuntimeError(f"observability: /metrics answered {status}, requests "
                           f"{metrics.get(MODEL, {}).get('requests')}, want the {want} sent")
    dev = metrics.get("device", {})
    if on_card and not (dev.get("source") == "memory_stats" and dev["hbm_bytes_in_use"] > 0):
        raise RuntimeError(f"observability: /metrics device is not a measurement: {dev}")
    status, headers, raw = _http_raw(port, "/metrics?format=prometheus")
    samples = check_prometheus(raw.decode())
    if status != 200 or not headers.get("Content-Type", "").startswith("text/plain"):
        raise RuntimeError(f"observability: the Prometheus view answered {status} {headers}")
    log(f"observability: /metrics counts the {want} POSTs sent; device in use "
        f"{dev.get('hbm_bytes_in_use', 0) / 1e9:.3f} GB ({dev.get('source')}); the Prometheus "
        f"view parses, {samples} samples")

    rid = "smoke-obs-1"
    tokens = torch.randint(0, cfg.vocab_size, (1, 64), generator=torch.Generator().manual_seed(7))
    status, headers, _ = _post(port, "/v1/forward", {"tokens": tokens.tolist()},
                               headers={"X-ModelX-Request-Id": rid, "X-ModelX-Attempt": "2"})
    if (status, headers.get("X-ModelX-Request-Id"), headers.get("X-ModelX-Attempt")) != (
            200, rid, "2"):
        raise RuntimeError(f"observability: the request id did not echo: {status} {headers}")
    # the request's span closes after its last byte: poll briefly for it
    want_spans = {"serve.request": 1, "serve.request/serve.forward": 1}
    deadline = time.monotonic() + 10
    while True:
        status, spans = _http(port, f"/v1/trace?request_id={rid}")
        counts = {p: a["count"] for p, a in spans.items()}
        if counts == want_spans or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    if counts != want_spans:
        raise RuntimeError(f"observability: /v1/trace?request_id= gave {counts}")

    # spans time host work only: their cost is the tracer's whole cost
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        with trace.span("smoke.cost"):
            pass
    stats["obs_span_us"] = (time.perf_counter() - t0) / n * 1e6

    # the profile window: the forwards start once the profiler runs
    long_tokens = torch.randint(0, cfg.vocab_size, PROFILE_FORWARD,
                                generator=torch.Generator().manual_seed(8)).tolist()
    fwd_ms, errors = [], []

    def forwards():
        try:
            deadline = time.monotonic() + 120
            while not trace.profile_active():
                if time.monotonic() > deadline:
                    raise RuntimeError("the profiler never started")
                time.sleep(0.005)
            for _ in range(2):
                t1 = time.monotonic()
                st, _ = _http(port, "/v1/forward", {"tokens": long_tokens})
                fwd_ms.append((time.monotonic() - t1) * 1e3)
                if st != 200:
                    raise RuntimeError(f"/v1/forward answered {st}")
        except Exception as e:
            errors.append(e)

    before = attn.flash_attention.launches
    th = threading.Thread(target=forwards, daemon=True)
    th.start()
    t0 = time.monotonic()
    status, body = _http(port, "/v1/profile", {"seconds": PROFILE_SECONDS})
    profile_s = time.monotonic() - t0
    th.join(timeout=300)
    if status != 200 or errors or len(fwd_ms) != 2:
        raise RuntimeError(f"observability: /v1/profile answered {status} {body}; the window's "
                           f"forwards: {fwd_ms} {errors}")
    if attn.flash_attention.launches - before != 2 * per_forward:
        raise RuntimeError("observability: the window's forwards did not launch the kernel "
                           "once a layer each")
    path = os.path.join(body["trace_dir"], trace.TRACE_FILE)
    kernels = trace_kernels(path)
    flash = sum(c for k, c in kernels.items() if "flash_fwd" in k)
    gemms = sum(c for k, c in kernels.items() if GEMM_NAME.search(k))
    stats.update(obs_profile_s=profile_s, obs_trace_bytes=os.path.getsize(path),
                 obs_profile_flash_events=flash, obs_profile_gemm_events=gemms,
                 obs_profile_forward_ms=fwd_ms)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    log(f"observability: /v1/profile {PROFILE_SECONDS} s took {profile_s:.2f} s (the first "
        f"start loads the profiler); trace {stats['obs_trace_bytes'] / 1e6:.2f} MB with "
        f"{sum(kernels.values())} kernel events: {flash} flash, {gemms} GEMM; the window's "
        f"[1,{PROFILE_FORWARD[1]}] forwards {[round(x, 1) for x in fwd_ms]} ms; top kernels "
        f"{[(kernel_label(k)[:60], c) for k, c in top]}")
    if on_card and (flash < 2 * cfg.num_layers or gemms < 2 * cfg.num_layers):
        raise RuntimeError(f"observability: the capture holds {flash} flash and {gemms} GEMM "
                           f"events, want >= {2 * cfg.num_layers} each")

    t0 = time.monotonic()
    for _ in range(ADMIN_PROFILES):
        status, body = _http(port, "/admin/profile", {"duration_s": ADMIN_PROFILE_SECONDS})
        if status != 200:
            raise RuntimeError(f"observability: /admin/profile answered {status} {body}")
    captures = os.path.join(sset.trace_dir, "captures")
    kept = os.listdir(captures)
    if len(kept) != 4:
        raise RuntimeError(f"observability: {ADMIN_PROFILES} captures left {kept}, want 4")
    stats["obs_admin_profiles_s"] = time.monotonic() - t0
    stats["obs_capture_bytes"] = sum(os.path.getsize(os.path.join(r, f))
                                     for r, _, fs in os.walk(captures) for f in fs)

    # a line is written once its request's last byte is out: poll briefly
    deadline = time.monotonic() + 10
    while True:
        with open(os.path.join(obs_dir, "access.jsonl")) as f:
            lines = [json.loads(x) for x in f.read().splitlines()]
        if len(lines) >= POSTS[port] or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    if len(lines) != POSTS[port] or lines[-1]["path"] != "/admin/profile":
        raise RuntimeError(f"observability: the access log has {len(lines)} lines for the "
                           f"{POSTS[port]} POSTs sent")
    log(f"observability: request id echoed with its attempt, /v1/trace sliced it to {counts}; "
        f"{ADMIN_PROFILES} /admin/profile captures in {stats['obs_admin_profiles_s']:.2f} s left "
        f"4 dirs ({stats['obs_capture_bytes'] / 1e6:.2f} MB); the access log has one line per "
        f"POST ({len(lines)}); a span costs {stats['obs_span_us']:.2f} us of host time")
    return stats


def _device_events(fn) -> int:
    """Device operations (kernels, copies, fills) ``fn`` runs, from a
    ``torch.profiler`` trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def check_sampler(server, cfg, on_card: bool) -> dict:
    """The sampler on the server's device against its plain versions:
    ``scale_and_filter`` == ``scale_and_filter_reference`` byte for byte at
    [4, vocab] (a batch whose cuts fit, and one that overflows), and
    ``sample``'s keys, bits, uniforms and Gumbel noise on the device equal
    the CPU's exactly, its tokens too but at near-ties. Then its times per
    step at [1, vocab], and device launches per decode step."""
    import torch

    from modelx_tpu_torch.models import llama
    from modelx_tpu_torch.ops import prng
    from modelx_tpu_torch.ops import sampling as S

    dev, v = server.device, cfg.vocab_size
    gen = torch.Generator().manual_seed(3)
    flat = torch.randn(4, v, generator=gen) * 3
    peaked = torch.randn(4, v, generator=gen) * 12
    t = torch.tensor([0.8, 1.0, 0.0, 1.3])
    cases = {  # name: (logits, top_k, top_p, must sort)
        "fits": (peaked, torch.tensor([40, 1, 10, 64]), torch.tensor([0.95, 1.0, 0.5, 0.9]),
                 False),
        "overflows": (flat, torch.tensor([40, 0, 5, 2000]),
                      torch.tensor([0.95, 0.99, 0.9, 1.0]), True),
    }
    for name, (lg, k, p, must_sort) in cases.items():
        args = (lg.to(dev), t.to(dev), k.to(dev), p.to(dev))
        sorts = S.scale_and_filter.sorts
        fused = S.scale_and_filter(*args)
        sorted_ = S.scale_and_filter.sorts != sorts
        ref = S.scale_and_filter_reference(*args)
        same = torch.equal(fused.view(torch.int32), ref.view(torch.int32))
        log(f"sampler: scale_and_filter [{name}] [4, {v}] fp32 on {dev}: "
            f"{'full-sort' if sorted_ else 'fused'} branch; equals the always-sort "
            f"reference byte for byte: {same}")
        if not same or sorted_ != must_sort:
            raise RuntimeError(f"scale_and_filter [{name}] disagrees with its reference")

    lg, k, p = cases["overflows"][0], cases["fits"][1], cases["fits"][2]
    seeds, steps = torch.tensor([7, 8, 9, 10]), torch.tensor([0, 5, 31, 2])
    key = prng.PRNGKey(0)
    keys = prng.fold_in(prng.fold_in(key, seeds), steps)
    keys_dev = prng.fold_in(prng.fold_in(key.to(dev), seeds.to(dev)), steps.to(dev))
    checks = {
        "keys": (keys, keys_dev),
        "bits": (prng.bits(keys, v), prng.bits(keys_dev, v)),
        "uniforms": (prng.uniform(keys, v), prng.uniform(keys_dev, v)),
        "gumbel": (prng.gumbel(keys, v), prng.gumbel(keys_dev, v)),
    }
    for name, (cpu, on_dev) in checks.items():
        if not torch.equal(cpu, on_dev.cpu()):
            raise RuntimeError(f"sampler: {name} on {dev} differ from the CPU's")
    tok_cpu = S.sample(lg, key, t, k, p, seeds=seeds, step=steps)
    tok_dev = S.sample(lg.to(dev), key.to(dev), t.to(dev), k.to(dev), p.to(dev),
                       seeds=seeds.to(dev), step=steps.to(dev)).cpu()
    noisy = S.scale_and_filter_reference(lg, t, k, p) + checks["gumbel"][0]
    top2 = noisy.topk(2, dim=-1).values
    near = (top2[:, 0] - top2[:, 1]) < NEAR_TIE
    bad = (tok_cpu != tok_dev) & ~near
    log(f"sampler: sample on {dev} vs the CPU at [4, {v}]: keys, bits, uniforms, Gumbel "
        f"noise bit-equal; tokens equal at {int((tok_cpu == tok_dev).sum())}/4 rows "
        f"({int(near.sum())} near-ties under {NEAR_TIE})")
    if bool(bad.any()):
        raise RuntimeError("sample on the device draws other tokens than on the CPU")

    out: dict = {}
    if not on_card:
        return out
    # per-step cost at [1, vocab], back to back (CUDA events); inputs on the card
    peaked1, flat1 = peaked[:1].to(dev), flat[:1].to(dev)
    t1, s1, k1, p1, key_dev = (x.to(dev) for x in (
        torch.tensor([0.8]), torch.tensor([7]), torch.tensor([40]), torch.tensor([0.95]), key))
    times = {
        "argmax (greedy)": lambda: torch.argmax(peaked1, dim=-1),
        "sample, temperature only": lambda: S.sample(peaked1, key_dev, t1, seeds=s1, step=3),
        "sample, top_k 40 + top_p 0.95, fused branch":
            lambda: S.sample(peaked1, key_dev, t1, k1, p1, seeds=s1, step=3),
        "sample, top_k 40 + top_p 0.95, full-sort branch":
            lambda: S.sample(flat1, key_dev, t1, k1, p1, seeds=s1, step=3),
        "scale_and_filter, fused": lambda: S.scale_and_filter(peaked1, t1, k1, p1),
        "scale_and_filter_reference (always sorts)":
            lambda: S.scale_and_filter_reference(peaked1, t1, k1, p1),
    }
    for name, fn in times.items():
        ms = time_ms(fn, iters=20, reps=3)
        out[f"sampler_ms[{name}]"] = ms
        log(f"sampler: {name} at [1, {v}] fp32: {ms:.4f} ms a step (back to back)")

    # device launches per decode step: (N + 1 new tokens) - (N), greedy and sampled
    prompt = torch.randint(0, v, (1, 128), generator=gen).to(dev)

    def decode(n_new, **samp):
        with torch.inference_mode():
            llama.ragged_greedy_generate(server.params, prompt, [128], server.cfg,
                                         max_new_tokens=n_new, **samp).cpu()

    sampled = dict(temperature=[0.8], top_k=[40], top_p=[0.95], seeds=[7])
    decode(3)
    decode(3, **sampled)
    for name, samp in (("greedy", {}), ("sampled", sampled)):
        per_step = _device_events(lambda: decode(3, **samp)) - _device_events(
            lambda: decode(2, **samp))
        out[f"device_ops_per_{name}_step"] = per_step
        log(f"sampler: device operations per {name} decode step (Llama-3-8B shape, "
            f"torch.profiler): {per_step}")
    return out


# -- phase 5: text in/out and the OpenAI surface -------------------------------------

# Meta-Llama-3-8B's tokenizer.json: its pre-tokenizer regex, its 256
# special tokens at ids 128000-128255, and Llama-3-8B-Instruct's chat template
LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?"
                  r"[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
LLAMA3_SPECIALS = (
    ["<|begin_of_text|>", "<|end_of_text|>"]
    + [f"<|reserved_special_token_{i}|>" for i in range(4)]
    + ["<|start_header_id|>", "<|end_header_id|>", "<|reserved_special_token_4|>", "<|eot_id|>"]
    + [f"<|reserved_special_token_{i}|>" for i in range(5, 251)]
)
LLAMA3_CHAT_TEMPLATE = (
    "{% set loop_messages = messages %}{% for message in loop_messages %}"
    "{% set content = '<|start_header_id|>' + message['role'] + '<|end_header_id|>\n\n'"
    "+ message['content'] | trim + '<|eot_id|>' %}{% if loop.index0 == 0 %}"
    "{% set content = bos_token + content %}{% endif %}{{ content }}{% endfor %}"
    "{% if add_generation_prompt %}{{ '<|start_header_id|>assistant<|end_header_id|>\n\n' }}"
    "{% endif %}"
)
# the words the smoke's merge table spells out, bare and after a space,
# lower case and capitalized
ENGLISH = (
    "the of and to a in is it you that he was for on are with as i his they be at one have "
    "this from or had by word but what some we can out other were all there when up use your "
    "how said an each she which do their time if will way about many then them write would "
    "like so these her long make thing see him two has look more day could go come did number "
    "no most people my over know water than call first who may down side been now find any "
    "new work part take get place made live where after back little only round man year came "
    "show every good me give our under name very through just form sentence great think say "
    "help low line turn cause much mean before move right old too same tell does set three "
    "want well also play small end put home read hand large add even land here must big high "
    "such follow act why ask change went light kind off need house try us again point world "
    "near build model serve serves text card answer answers question kernel tokens decode "
    "words comes chat assistant helpful tell me about"
).split()
TEXT_PROMPT = ("The model serves text on the card, and each answer comes back as tokens "
               "that decode to words.")
CHAT_MESSAGES = [
    {"role": "system", "content": "You are a helpful assistant."},
    {"role": "user", "content": "Tell me about the kernel that serves this model."},
]


def _gpt2_byte_chars() -> dict[int, str]:
    keep = [*range(0x21, 0x7F), *range(0xA1, 0xAD), *range(0xAE, 0x100)]
    out, extra = {}, 0
    for b in range(256):
        out[b] = chr(b) if b in keep else chr(256 + (extra := extra + 1) - 1)
    return out


def llama3_tokenizer_json(vocab_size: int = 128000) -> str:
    """A tokenizer.json with Llama-3's components (the Split regex and a
    ByteLevel without regex, BPE with ``ignore_merges``, a bos template, the
    ByteLevel decoder) and its 256 special tokens at ids ``vocab_size`` on.
    The ``vocab_size`` regular tokens are the 256 bytes, the words of
    ``ENGLISH`` built letter by letter (so merges apply to English text),
    then pairs of earlier tokens, in a fixed order: the same file every time."""
    b2c = _gpt2_byte_chars()
    vocab = {b2c[b]: b for b in range(256)}
    merges: list[list[str]] = []

    def add(a: str, b: str) -> str:
        if a + b not in vocab and len(vocab) < vocab_size:
            vocab[a + b] = len(vocab)
            merges.append([a, b])
        return a + b

    for w in ENGLISH:
        for word in (w, w.capitalize(), " " + w, " " + w.capitalize()):
            chars = [b2c[b] for b in word.encode()]
            acc = chars[0]
            for ch in chars[1:]:
                acc = add(acc, ch)
    toks, i = list(vocab), 0
    while len(vocab) < vocab_size:
        a, b = toks[i % len(toks)], toks[(i * 7919 + 13) % 256]
        if a + b not in vocab:
            toks.append(add(a, b))
        i += 1
    bos = LLAMA3_SPECIALS[0]
    seq = {"Sequence": {"id": "A", "type_id": 0}}
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [
            {"id": vocab_size + i, "content": c, "single_word": False, "lstrip": False,
             "rstrip": False, "normalized": False, "special": True}
            for i, c in enumerate(LLAMA3_SPECIALS)],
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_PATTERN}, "behavior": "Isolated",
             "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
             "use_regex": False}]},
        "post_processor": {"type": "Sequence", "processors": [
            {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": False,
             "use_regex": True},
            {"type": "TemplateProcessing",
             "single": [{"SpecialToken": {"id": bos, "type_id": 0}}, seq],
             "pair": [{"SpecialToken": {"id": bos, "type_id": 0}}, seq,
                      {"SpecialToken": {"id": bos, "type_id": 1}},
                      {"Sequence": {"id": "B", "type_id": 1}}],
             "special_tokens": {bos: {"id": bos, "ids": [vocab_size], "tokens": [bos]}}}]},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                    "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": merges},
    }
    return json.dumps(spec, ensure_ascii=False)


def write_text_files(model_dir: str, vocab_size: int = 128000) -> None:
    """The smoke's tokenizer.json and a tokenizer_config.json carrying
    Llama-3-Instruct's chat template, beside the checkpoint."""
    with open(os.path.join(model_dir, "tokenizer.json"), "w", encoding="utf-8") as f:
        f.write(llama3_tokenizer_json(vocab_size))
    with open(os.path.join(model_dir, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump({"bos_token": LLAMA3_SPECIALS[0], "eos_token": "<|eot_id|>",
                   "chat_template": LLAMA3_CHAT_TEMPLATE}, f)


# the scoring forward through the kernel against the same forward through
# the plain attention, both in bf16 on the card: per-token logprobs agree
# within this. The main phase's kernel-path vs plain-path check sees the
# two paths' logits differ by up to ~4 bf16 ulps (0.117 at a logit maximum
# of 5.84 on [1, 2048], NVIDIA H100); the bound allows twice that
SCORE_TOL = 0.25
TEXT_NEW_TOKENS = 24


def _sse(port: int, path: str, body: dict, timeout: float = 600.0):
    """POST a streamed OpenAI request; (events before [DONE], seconds to
    the first content event, seconds in all). Fails on a non-200, an error
    event or a missing [DONE]."""
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps({**body, "stream": True}).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    events, first, done = [], None, False
    with urllib.request.urlopen(req, timeout=timeout) as r:
        if r.status != 200:
            raise RuntimeError(f"SSE answered {r.status}")
        for raw in r:
            line = raw.decode().strip()
            if not line:
                continue
            if line == "data: [DONE]":
                done = True
                continue
            ev = json.loads(line.removeprefix("data: "))
            events.append(ev)
            delta = next(iter(ev.get("choices") or []), {})
            if first is None and (delta.get("delta", {}).get("content") or delta.get("text")):
                first = time.monotonic() - t0
    total = time.monotonic() - t0
    if not done or any("error" in e for e in events):
        raise RuntimeError(f"bad SSE stream: {events[-3:]}")
    return events, first, total


def _openai(port: int, path: str, body: dict) -> tuple[dict, float]:
    t0 = time.monotonic()
    status, out = _http(port, path, body)
    secs = time.monotonic() - t0
    if status != 200:
        raise RuntimeError(f"{path} answered {status} {str(out)[:300]}")
    return out, secs


def check_chat_prompt(server, messages) -> list[int]:
    """The chat prompt's ids as the server renders them: through the model's
    own template, which must have loaded (no silent fall back to the
    generic one, e.g. for want of jinja2) and must put Llama-3's header
    tokens into the ids."""
    spec = server.chat_template()
    if spec is None:
        raise RuntimeError("the model's chat template did not load (is jinja2 installed?)")
    tok = server.tokenizer()
    ids = tok.encode(spec["compiled"].render(
        messages=messages, add_generation_prompt=True, bos_token=spec["bos_token"],
        eos_token=spec["eos_token"]), add_special_tokens=False)
    header = tok.encode("<|start_header_id|>", add_special_tokens=False)
    if len(header) != 1 or header[0] not in ids:
        raise RuntimeError("the chat prompt holds no <|start_header_id|>: not the model's "
                           "template")
    return ids


def check_sse_deltas(events: list, whole: str, chat: bool) -> str:
    """The SSE events of one choice: the role chunk first (chat), content
    deltas that concatenate to ``whole``, one finish event."""
    if chat and events[0]["choices"][0]["delta"] != {"role": "assistant"}:
        raise RuntimeError(f"the first chat event is not the role chunk: {events[0]}")
    key = (lambda c: c["delta"].get("content", "")) if chat else (lambda c: c["text"])
    text = "".join(key(c) for e in events for c in e["choices"])
    if text != whole:
        raise RuntimeError(f"the stream's deltas {text!r} differ from the whole answer {whole!r}")
    finishes = [c["finish_reason"] for e in events for c in e["choices"] if c["finish_reason"]]
    if len(finishes) != 1:
        raise RuntimeError(f"the stream ended with {finishes}")
    return text


def plain_scores(server, rows: list, top_k: int):
    """``server.score_logprobs_rows`` computed with the plain attention
    (``attention_reference``) in place of the kernel, on the same device."""
    import numpy as np
    import torch

    from modelx_tpu_torch.models import llama
    from modelx_tpu_torch.models.decode import pad_seq_len

    out = []
    for ids, new_ids in rows:
        full = list(ids) + list(new_ids)
        toks = torch.zeros((1, pad_seq_len(len(full))), dtype=torch.int64)
        toks[0, : len(full)] = torch.tensor(full)
        with torch.inference_mode():
            toks = toks.to(server.device)
            logits, _ = llama.forward(server.params, toks, server.cfg,
                                      attention_impl="reference")
            lp = torch.log_softmax(logits[0].float(), dim=-1)
            lo, hi = len(ids) - 1, len(full) - 1
            chosen = lp[lo:hi].gather(-1, toks[0, lo + 1:hi + 1, None])[:, 0]
            top_lp = torch.topk(lp[lo:hi], top_k, dim=-1).values
        out.append((chosen.cpu().numpy(), top_lp.cpu().numpy().astype(np.float32)))
    return out


def phase_text(port: int, server, cfg, per_forward: int) -> dict:
    """Text in/out and the OpenAI surface on the running server: text on
    /v1/generate == the token request, a greedy completion == that text, a
    chat rendered through the model's template, an SSE chat whose deltas
    are the whole answer, a seeded sampled completion that repeats, a stop
    string that cuts, and ``logprobs`` scored by a cache-free forward that
    launches the flash kernel ``per_forward`` times and agrees with the
    plain attention's scores within ``SCORE_TOL``."""
    import numpy as np

    from modelx_tpu_torch.ops import attention as attn

    stats: dict = {}
    n = TEXT_NEW_TOKENS
    t0 = time.monotonic()
    tok = server.tokenizer()
    if tok is None:
        raise RuntimeError("the model's tokenizer.json did not load")
    stats["tokenizer_load_ms"] = (time.monotonic() - t0) * 1e3
    corpus = " ".join([TEXT_PROMPT, CHAT_MESSAGES[1]["content"]] * 200)
    rates = []
    for _ in range(2):  # the first pass fills the per-word cache
        t0 = time.monotonic()
        n_corpus = len(tok.encode(corpus))
        rates.append(n_corpus / (time.monotonic() - t0))
    # words outside the vocab, each new to the cache: the merge loop's cost
    fresh = [f"{a}{b}" for a, b in zip(ENGLISH, ENGLISH[7:] + ENGLISH[:7])][:500]
    t0 = time.monotonic()
    tok.encode(" ".join(fresh), add_special_tokens=False)
    stats["bpe_us_per_new_word"] = (time.monotonic() - t0) / len(fresh) * 1e6
    stats["encode_tokens_per_s"] = rates[1]
    log(f"text: tokenizer.json ({cfg.vocab_size} ids) read by the port in "
        f"{stats['tokenizer_load_ms']:.1f} ms; encode {rates[0]:.0f} tokens/s first pass, "
        f"{rates[1]:.0f} warm ({n_corpus} tokens of English); BPE "
        f"{stats['bpe_us_per_new_word']:.1f} us per word new to the cache "
        f"({len(fresh)} words outside the vocab)")

    ids = tok.encode(TEXT_PROMPT)
    status, by_text = _http(port, "/v1/generate", {"text": TEXT_PROMPT, "max_new_tokens": n})
    _, by_ids = _http(port, "/v1/generate", {"tokens": [ids], "max_new_tokens": n})
    if status != 200 or by_text["tokens"] != by_ids["tokens"] or by_text["tokens"][0][
            :len(ids)] != ids:
        raise RuntimeError(f"text on /v1/generate differs from the token request: "
                           f"{str(by_text)[:300]}")
    new = by_text["tokens"][0][len(ids):]
    if by_text["text"] != tok.decode(new):
        raise RuntimeError("the text answer is not the decode of its new tokens")
    body = {"prompt": TEXT_PROMPT, "max_tokens": n, "temperature": 0, "seed": 0,
            "ignore_eos": True}
    comp, secs = _openai(port, "/v1/completions", body)
    if comp["choices"][0]["text"] != by_text["text"]:
        raise RuntimeError("a greedy /v1/completions differs from text /v1/generate")
    log(f"text: {len(ids)}-token prompt + {n}: /v1/generate text == tokens, /v1/completions "
        f"== /v1/generate ({secs:.3f} s); {by_text['text'][:60]!r}...")
    stats["completion_s"] = secs

    chat_ids = check_chat_prompt(server, CHAT_MESSAGES)
    chat_body = {"messages": CHAT_MESSAGES, "max_tokens": n, "temperature": 0, "seed": 0,
                 "ignore_eos": True}
    chat, secs = _openai(port, "/v1/chat/completions", chat_body)
    _, plain = _http(port, "/v1/generate", {"tokens": [chat_ids], "max_new_tokens": n})
    whole = chat["choices"][0]["message"]["content"]
    if chat["usage"]["prompt_tokens"] != len(chat_ids) or whole != tok.decode(
            plain["tokens"][0][len(chat_ids):]):
        raise RuntimeError("the chat completion is not the generate of its templated prompt")
    events, first_s, total_s = _sse(port, "/v1/chat/completions", chat_body)
    check_sse_deltas(events, whole, chat=True)
    log(f"text: /v1/chat/completions ({len(chat_ids)}-token templated prompt, "
        f"<|start_header_id|> in it) + {n}: {secs:.3f} s; SSE deltas == the whole answer, "
        f"first content event {first_s * 1e3:.1f} ms, {total_s:.3f} s in all")
    stats.update(chat_s=secs, sse_first_content_ms=first_s * 1e3, sse_s=total_s)

    sampled = {**body, "temperature": 0.8, "top_k": 40, "seed": 7}
    one, _ = _openai(port, "/v1/completions", sampled)
    two, _ = _openai(port, "/v1/completions", sampled)
    events, _, _ = _sse(port, "/v1/completions", sampled)
    check_sse_deltas(events, one["choices"][0]["text"], chat=False)
    if one["choices"] != two["choices"]:
        raise RuntimeError("a seeded sampled completion did not repeat")
    full = comp["choices"][0]["text"]
    at = next((i for i in range(len(full) // 2, len(full)) if not full[i].isspace()), None)
    if at is None:
        raise RuntimeError(f"no stop string to cut the greedy text {full!r} with")
    stop = full[at:at + 3]
    cut, _ = _openai(port, "/v1/completions", {**body, "stop": [stop]})
    want = full[:full.find(stop)]
    if cut["choices"][0]["text"] != want or cut["choices"][0]["finish_reason"] != "stop":
        raise RuntimeError(f"stop {stop!r} did not cut {full!r} to {want!r}: {cut['choices']}")
    log(f"text: a seeded sampled completion repeats, streamed too; stop {stop!r} cuts the "
        f"greedy text to {len(want)} of {len(full)} characters")

    before = attn.flash_attention.launches
    scored, secs = _openai(port, "/v1/completions", {**body, "logprobs": 5})
    rose = attn.flash_attention.launches - before
    # the text path ends here: the launches below compare the kernel with
    # the plain attention and do not count
    stats["flash_launches_text"] = attn.flash_attention.launches
    lp = scored["choices"][0]["logprobs"]
    if rose != per_forward:
        raise RuntimeError(f"logprobs: flash_attention launched {rose} times, want "
                           f"{per_forward} (one scoring forward)")
    values = np.asarray(lp["token_logprobs"], np.float64)
    if len(values) != n or not np.isfinite(values).all() or (values > 0).any() or any(
            len(t) < 1 for t in lp["top_logprobs"]):
        raise RuntimeError(f"logprobs: bad values {lp['token_logprobs'][:5]}")
    t0 = time.monotonic()
    (kernel_chosen, _, kernel_top), = server.score_logprobs_rows([(ids, new)], top_k=5)
    stats["score_ms"] = (time.monotonic() - t0) * 1e3
    (plain_chosen, plain_top), = plain_scores(server, [(ids, new)], top_k=5)
    diff = max(float(np.abs(kernel_chosen - plain_chosen).max()),
               float(np.abs(kernel_top - plain_top).max()))
    if not diff <= SCORE_TOL or float(np.abs(kernel_chosen - values).max()) > SCORE_TOL:
        raise RuntimeError(f"logprobs: the kernel's scores differ from the plain "
                           f"attention's by {diff} (tolerance {SCORE_TOL})")
    log(f"text: logprobs 5 over {len(ids)} + {n} tokens: 200 in {secs:.3f} s; flash_attention "
        f"launches +{rose}; the scoring forward {stats['score_ms']:.1f} ms; kernel vs plain "
        f"attention scores max |diff| {diff:.4f} (tolerance {SCORE_TOL})")
    stats.update(logprobs_s=secs, score_max_diff=diff)
    return stats


# -- phase 6: the serving options ---------------------------------------------------

# the dynamic batch burst: forward shapes, greedy prompt lengths, and the
# seeded sampled requests (prompt length, controls), each row one request
BATCH_FORWARD_SHAPES = ((1, 128), (1, 512), (2, 300), (1, 1000), (1, 64), (1, 256), (3, 100),
                        (1, 700))
BATCH_GREEDY_PROMPTS = (64, 128, 256, 512)
BATCH_SAMPLED = ((96, {"temperature": 0.8, "seed": 21}), (200, {"temperature": 1.0, "seed": 5}))
BATCH_NEW_TOKENS = 32
# long enough that requests sent at once from threads land in one window
BATCH_WINDOW_MS = 50.0
# a batched or speculative token may differ from the plain path's
# only where it lies this close below the maximum of the plain path's logits
# on its own prefix (Gumbel-perturbed for a sampled request, in units of the
# unscaled logits): twice the ~4 bf16 ulps (0.117 at a logit maximum of 5.84)
# two bf16 paths of one forward differ by in the main phase (NVIDIA H100)
OPTIONS_TIE_TOL = 0.25
SPEC_K = 8
SPEC_PERIOD, SPEC_REPEATS, SPEC_NEW_TOKENS = 32, 8, 64
INT8_FORWARD = (1, 2048)
INT8_PROMPT, INT8_NEW_TOKENS = 128, 32
LORA_R, LORA_ALPHA = 16, 32


def _uncounted(fn):
    """Run ``fn`` (a comparison, not the path) without its kernel launches
    entering the path's count."""
    from modelx_tpu_torch.ops import attention as attn

    before = attn.flash_attention.launches
    try:
        return fn()
    finally:
        attn.flash_attention.launches = before


def check_near_ties(server, prompt: list, got: list, want: list, what: str,
                    samp: dict | None = None) -> str:
    """``got`` (a batched or speculative answer to a single-row generate)
    against ``want`` (the plain path's): equal, or each of its tokens within
    ``OPTIONS_TIE_TOL`` of the maximum on its own prefix. The replay feeds
    ``got`` through the plain decode; a sampled request's logits are scaled
    and perturbed by its own Gumbel noise (``ops/prng``, the card's bits)."""
    import torch

    from modelx_tpu_torch.ops import prng

    if got == want:
        return "equal"
    if len(got) != len(want):
        raise RuntimeError(f"{what}: {len(got)} tokens, the plain path {len(want)}")
    _, logits = _uncounted(lambda: _replay_step_logits(server, prompt, got))
    logits = logits.float().cpu()
    tol = OPTIONS_TIE_TOL
    if samp:
        keys = prng.fold_in(prng.fold_in(prng.PRNGKey(0), samp["seed"]),
                            torch.arange(len(got)))
        logits = logits / samp["temperature"] + prng.gumbel(keys, logits.shape[-1])
        tol /= samp["temperature"]
    j0 = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    if logits[: j0 + 1].argmax(-1).tolist() != want[: j0 + 1]:
        raise RuntimeError(f"{what}: the replay differs from the plain path before step {j0}")
    # how far below each step's maximum its token lies
    gaps = (logits.max(-1).values - logits[torch.arange(len(got)), torch.tensor(got)]).tolist()
    worst = max(gaps)
    if worst > tol:
        j = gaps.index(worst)
        raise RuntimeError(f"{what}: token {got[j]} at step {j} lies {worst:.4f} below the "
                           f"maximum on its prefix (tolerance {tol:.4f})")
    return f"differs from step {j0}; every token within {worst:.4f} of the maximum on its prefix"


def check_forward_ties(server, tokens, got, want, what: str) -> str:
    """A batched ``/v1/forward`` answer against the request alone: equal, or
    each differing position's token within ``OPTIONS_TIE_TOL`` of the
    maximum of the lone forward's logits there."""
    import torch

    got, want = torch.tensor(got), torch.tensor(want)
    if torch.equal(got, want):
        return "equal"
    diff = (got != want).nonzero().tolist()

    def lone_logits():
        with torch.inference_mode():
            t = torch.as_tensor(tokens, dtype=torch.int64).to(server.device)
            return server.family.forward(server.params, t, server.cfg).float().cpu()

    logits = _uncounted(lone_logits)
    if not torch.equal(logits.argmax(-1), want):
        raise RuntimeError(f"{what}: the lone forward in-process differs from /v1/forward's")
    gaps = [float(logits[b, s].max() - logits[b, s, got[b, s]]) for b, s in diff]
    if max(gaps) > OPTIONS_TIE_TOL:
        raise RuntimeError(f"{what}: {len(diff)} positions differ, one by {max(gaps):.4f} below "
                           f"the maximum (tolerance {OPTIONS_TIE_TOL})")
    return f"{len(diff)} positions differ, each within {max(gaps):.4f} of the maximum"


def _burst(port: int, requests: list) -> list:
    """Send every (path, body) at once, one thread each; (status, body,
    seconds) per request and the burst's wall seconds."""
    import threading

    out = [None] * len(requests)
    errors = []
    gate = threading.Barrier(len(requests) + 1)

    def go(i, path, body):
        gate.wait()
        t0 = time.monotonic()
        try:
            status, got = _http(port, path, body)
        except OSError as e:
            errors.append(f"{path}: {e!r}")
            return
        out[i] = (status, got, time.monotonic() - t0)

    threads = [threading.Thread(target=go, args=(i, *r), daemon=True)
               for i, r in enumerate(requests)]
    for t in threads:
        t.start()
    gate.wait()
    t0 = time.monotonic()
    for t in threads:
        t.join(timeout=600)
        if t.is_alive():
            raise RuntimeError("a batched request did not finish in 600 s")
    if errors:
        raise RuntimeError(f"batched requests failed: {errors}")
    return out, time.monotonic() - t0


def _memory(what: str, on_card: bool) -> float | None:
    import torch

    if not on_card:
        return None
    torch.cuda.synchronize()
    gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"options: {what}: torch.cuda.max_memory_allocated {gb:.3f} GB "
        f"(allocated now {torch.cuda.memory_allocated() / 1e9:.3f} GB)")
    return gb


def _free(*servers) -> None:
    import gc

    import torch

    for s in servers:
        s.params = None
        s._decoders.clear()
        s._spec_decoder = None
        if s._prefix_cache is not None:
            s._prefix_cache.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def phase_options(port: int, server, cfg, ckpt: str, per_forward: int, main: dict) -> dict:
    """The serving options on the running bf16 server and the checkpoint
    behind it (see the module docstring). ``port`` serves ``server`` without
    a batcher (the lone reference); ``main`` holds the main phase's bf16
    figures the int8 server is set beside."""
    from modelx_tpu_torch.ops import attention as attn

    stats: dict = {}
    stats.update(options_batch(port, server, cfg, per_forward))
    stats.update(options_speculation(port, server, cfg, ckpt))
    stats.update(options_int8(port, server, cfg, ckpt, per_forward, main))
    _free(server)  # the LoRA server loads alone
    stats.update(options_lora(cfg, ckpt, per_forward, server.device.type))
    stats["flash_launches_options"] = attn.flash_attention.launches
    return stats


def options_batch(port: int, server, cfg, per_forward: int) -> dict:
    """The dynamic batcher: a burst of mixed requests on a ``dynamic_batch``
    front against each request sent alone to ``port``."""
    import torch

    from modelx_tpu_torch.dl.serve import ServerSet, serve
    from modelx_tpu_torch.ops import attention as attn

    gen = torch.Generator().manual_seed(6)

    def rand(shape):
        return torch.randint(0, cfg.vocab_size, shape, generator=gen).tolist()

    requests = [("/v1/forward", {"tokens": rand(shape)}) for shape in BATCH_FORWARD_SHAPES]
    requests += [("/v1/generate", {"tokens": rand((1, n)), "max_new_tokens": BATCH_NEW_TOKENS})
                 for n in BATCH_GREEDY_PROMPTS]
    requests += [("/v1/generate", {"tokens": rand((1, n)), "max_new_tokens": BATCH_NEW_TOKENS,
                                   **samp}) for n, samp in BATCH_SAMPLED]
    # the lone reference: each request alone on the server without the batcher
    lone = []
    for path, body in requests:
        t0 = time.monotonic()
        status, got = _http(port, path, body)
        if status != 200:
            raise RuntimeError(f"lone {path} answered {status} {str(got)[:200]}")
        lone.append((got, time.monotonic() - t0))

    bsset = ServerSet({server.name: server}, dynamic_batch=True,
                      batch_window_ms=BATCH_WINDOW_MS)
    bport = _free_port()
    httpd = serve(bsset, listen=f"127.0.0.1:{bport}")
    groups = {"forward": [], "generate": []}
    fwd, ragged = server.forward_argmax, server.generate_ragged

    def counted_forward(tokens):
        groups["forward"].append(tuple(tokens.shape))
        return fwd(tokens)

    def counted_ragged(tokens, *a, **kw):
        groups["generate"].append(tuple(tokens.shape))
        return ragged(tokens, *a, **kw)

    try:
        server.forward_argmax, server.generate_ragged = counted_forward, counted_ragged
        before = attn.flash_attention.launches
        results, wall = _burst(bport, requests)
        rose = attn.flash_attention.launches - before
        batches = bsset.batchers[server.name].batches
    finally:
        del server.forward_argmax, server.generate_ragged
        httpd.shutdown()
        httpd.server_close()
        bsset.close()
    n = len(requests)
    log(f"options: dynamic batch: {n} requests sent at once ({len(BATCH_FORWARD_SHAPES)} "
        f"forward, {len(BATCH_GREEDY_PROMPTS)} greedy, {len(BATCH_SAMPLED)} sampled) ran as "
        f"{batches} device calls: forward groups {groups['forward']}, generate groups "
        f"{groups['generate']}; flash_attention launches +{rose}")
    if batches >= n or batches != len(groups["forward"]) + len(groups["generate"]):
        raise RuntimeError(f"the burst did not coalesce: {batches} device calls for {n} requests")
    if rose != per_forward * len(groups["forward"]):
        raise RuntimeError(f"forward groups launched the kernel {rose} times, want "
                           f"{per_forward} x {len(groups['forward'])}")
    notes = []
    for (path, body), (status, got, secs), (want, lone_s) in zip(requests, results, lone):
        if status != 200:
            raise RuntimeError(f"batched {path} answered {status} {str(got)[:200]}")
        shape = [len(body["tokens"]), len(body["tokens"][0])]
        if path == "/v1/forward":
            note = check_forward_ties(server, body["tokens"], got["logits_argmax"],
                                      want["logits_argmax"], f"batched forward {shape}")
        else:
            plen = shape[1]
            samp = {k: body[k] for k in ("temperature", "seed") if k in body} or None
            note = check_near_ties(server, body["tokens"][0], got["tokens"][0][plen:],
                                   want["tokens"][0][plen:], f"batched generate {shape}", samp)
            if got["tokens"][0][:plen] != body["tokens"][0]:
                raise RuntimeError("a batched generate did not echo its prompt")
        notes.append(note)
        log(f"options: batched {path} {shape}{' sampled' if 'seed' in body else ''}: "
            f"{secs * 1e3:.1f} ms batched, {lone_s * 1e3:.1f} ms alone; {note}")
    serial = sum(s for _, s in lone)
    log(f"options: dynamic batch: {n / wall:.2f} requests/s batched ({wall:.3f} s for the "
        f"burst) against {n / serial:.2f} alone in turn ({serial:.3f} s)")
    return {"batch_requests": n, "batch_device_calls": batches,
            "batch_requests_per_s": n / wall, "serial_requests_per_s": n / serial,
            "batch_equal": sum(x == "equal" for x in notes)}


def spec_prompt(cfg) -> list:
    """A seeded ``SPEC_PERIOD``-token period repeated ``SPEC_REPEATS``
    times: prompt lookup finds its continuation."""
    import torch

    gen = torch.Generator().manual_seed(8)
    return torch.randint(0, cfg.vocab_size, (SPEC_PERIOD,), generator=gen).tolist() * SPEC_REPEATS


def options_speculation(port: int, server, cfg, ckpt: str) -> dict:
    """``speculative_k`` on the loaded params: a self-repeating prompt's
    greedy tokens against plain greedy, and its stream against its whole
    answer."""
    from modelx_tpu_torch.dl.serve import ModelServer, ServerSet, serve

    prompt = spec_prompt(cfg)
    body = {"tokens": [prompt], "max_new_tokens": SPEC_NEW_TOKENS}
    t0 = time.monotonic()
    status, plain = _http(port, "/v1/generate", body)
    plain_s = time.monotonic() - t0
    if status != 200:
        raise RuntimeError(f"plain greedy answered {status}")
    # the same loaded params behind a server that speculates
    spec = ModelServer(ckpt, device=server.device, speculative_k=SPEC_K, name="spec")
    spec.family, spec.cfg, spec.params, spec.ready = server.family, server.cfg, server.params, True
    sport = _free_port()
    httpd = serve(ServerSet({"spec": spec}), listen=f"127.0.0.1:{sport}")
    try:
        t0 = time.monotonic()
        status, out = _http(sport, "/v1/generate", body)
        spec_s = time.monotonic() - t0
        if status != 200:
            raise RuntimeError(f"speculative greedy answered {status} {str(out)[:200]}")
        st = dict(spec.stats)
        streamed, first_s, _ = _stream(sport, body)
    finally:
        httpd.shutdown()
        httpd.server_close()
        spec.params = None
    plen = len(prompt)
    got, want = out["tokens"][0][plen:], plain["tokens"][0][plen:]
    note = check_near_ties(server, prompt, got, want, "speculative greedy")
    if streamed != got:
        raise RuntimeError("the speculative stream's chunks do not concatenate to its answer")
    steps, proposed, accepted = st["spec_device_steps"], st["spec_proposed"], st["spec_accepted"]
    rate = accepted / proposed if proposed else 0.0
    log(f"options: speculative_k {SPEC_K}, a {SPEC_PERIOD}-token period x {SPEC_REPEATS} "
        f"prompt + {SPEC_NEW_TOKENS}: {note}; stream == whole (first chunk "
        f"{first_s * 1e3:.1f} ms); {steps} device steps, {proposed} proposed, {accepted} "
        f"accepted (accept rate {rate:.3f}); {spec_s:.3f} s against {plain_s:.3f} s plain")
    return {"spec_steps": steps, "spec_proposed": proposed, "spec_accepted": accepted,
            "spec_accept_rate": rate, "spec_s": spec_s, "spec_plain_s": plain_s}


def options_int8(port: int, server, cfg, ckpt: str, per_forward: int, main: dict) -> dict:
    """``--quantize int8`` beside the bf16 server: codes and scales against
    the host rule, one int8 linear against its dequantized fp32 product, the
    kernel's launches on ``/v1/forward``, and its figures against bf16's."""
    import numpy as np
    import torch

    from modelx_tpu_torch.dl import safetensors as st
    from modelx_tpu_torch.dl import serve_main
    from modelx_tpu_torch.ops import attention as attn
    from modelx_tpu_torch.ops import nn, quant

    device = server.device.type
    on_card = device == "cuda"
    iport = _free_port()
    t0 = time.monotonic()
    isset, httpd = serve_main.start([
        "--model", f"int8={ckpt}", "--listen", f"127.0.0.1:{iport}", "--device", device,
        "--dtype", "bfloat16", "--quantize", "int8"])
    up_s = time.monotonic() - t0
    qserver = isset.servers["int8"]
    try:
        s = qserver.stats
        log(f"options: int8 server up in {up_s:.2f} s; {s['load_bytes'] / 1e9:.3f} GB over the "
            f"link at {s['load_gbps']} GB/s, {s['device_bytes'] / 1e9:.3f} GB on the device "
            f"(bf16 server: {server.stats['device_bytes'] / 1e9:.3f} GB)")
        peak = _memory("bf16 + int8 servers loaded", on_card)
        names = ["model.layers.0.self_attn.q_proj.weight",
                 f"model.layers.{cfg.num_layers - 1}.mlp.down_proj.weight", "lm_head.weight"]
        raw = st.read_tensors(os.path.join(ckpt, "model.safetensors"), want=names.__contains__)
        for name in names:
            w = raw[name].float().numpy()  # the checkpoint's bf16 values, exactly
            scale = quant.channel_scales(w)
            q = quant.quantize_rows(w, scale)
            got = qserver.params[name]
            bad_scales = int((got.scale.cpu().numpy().view(np.int32) != scale.view(np.int32)).sum())
            bad_codes = int((got.q.cpu().numpy() != q).sum())
            if bad_scales or bad_codes:
                raise RuntimeError(f"int8 {name}: {bad_scales} of {scale.size} scales and "
                                   f"{bad_codes} of {q.size} codes on the {device} differ from "
                                   f"the host rule's")
        log(f"options: int8 codes and scales of {names} equal the host numpy rule's byte for "
            f"byte")
        # one layer's int8 linear against x.float() @ dequantize(q).T in fp32
        torch.backends.cuda.matmul.allow_tf32 = False
        qt = qserver.params[names[0]]
        gen = torch.Generator().manual_seed(9)
        x = torch.randn(INT8_FORWARD[1], cfg.hidden_size, generator=gen).to(
            torch.bfloat16).to(server.device)
        with torch.inference_mode():
            y = nn.linear(x, qt).float()
            ref = x.float() @ quant.dequantize(qt).T
        atol, rtol = TOL["bfloat16"]
        err = (y - ref).abs()
        lin_err = float(err.max())
        if not bool((err <= atol + rtol * ref.abs()).all()):
            raise RuntimeError(f"int8 linear disagrees with its dequantized fp32 product: "
                               f"max_abs_err {lin_err}")
        route = "torch.mm(out_dtype=float32)" if on_card else "fp32 operands"
        log(f"options: int8 linear {names[0]} at x [{INT8_FORWARD[1]}, {cfg.hidden_size}] bf16: "
            f"max_abs_err {lin_err:.3e} against x.float() @ dequantize(q).T (tol {atol} + "
            f"{rtol}*|ref|); the product through {route}")

        tokens = torch.randint(0, cfg.vocab_size, INT8_FORWARD, generator=gen).tolist()
        ms = []
        for rep in range(2):
            before = attn.flash_attention.launches
            t0 = time.monotonic()
            status, got = _http(iport, "/v1/forward", {"tokens": tokens})
            ms.append((time.monotonic() - t0) * 1e3)
            if status != 200:
                raise RuntimeError(f"int8 /v1/forward answered {status}")
            if attn.flash_attention.launches - before != per_forward:
                raise RuntimeError(f"int8 /v1/forward launched the kernel "
                                   f"{attn.flash_attention.launches - before} times, want "
                                   f"{per_forward}")
        # the bf16 server's answer is a comparison: its launches do not count
        _, bf16 = _uncounted(lambda: _http(port, "/v1/forward", {"tokens": tokens}))
        agree = float(np.mean(np.asarray(got["logits_argmax"]) ==
                              np.asarray(bf16["logits_argmax"])))
        prompt = torch.randint(0, cfg.vocab_size, (1, INT8_PROMPT), generator=gen).tolist()
        t0 = time.monotonic()
        status, out = _http(iport, "/v1/generate", {"tokens": prompt,
                                                    "max_new_tokens": INT8_NEW_TOKENS})
        gen_s = time.monotonic() - t0
        if status != 200 or len(out["tokens"][0]) != INT8_PROMPT + INT8_NEW_TOKENS:
            raise RuntimeError(f"int8 /v1/generate answered {status}")
        bf16_ms = main.get(f"forward_ms_{INT8_FORWARD[0]}x{INT8_FORWARD[1]}")
        bf16_s = main.get(f"generate_s_{INT8_PROMPT}")
        log(f"options: int8 /v1/forward {list(INT8_FORWARD)}: {ms[0]:.1f} ms first, "
            f"{ms[1]:.1f} ms repeat (bf16 {bf16_ms and round(bf16_ms, 1)} ms), flash_attention "
            f"launches +{per_forward}; argmax equal to bf16's at {agree:.3f} of positions; "
            f"greedy {INT8_PROMPT} + {INT8_NEW_TOKENS}: {INT8_NEW_TOKENS / gen_s:.1f} tokens/s "
            f"(bf16 {bf16_s and round(INT8_NEW_TOKENS / bf16_s, 1)})")
        return {"int8_device_gb": s["device_bytes"] / 1e9, "int8_load_gbps": s["load_gbps"],
                "int8_forward_ms": ms[1], "int8_tokens_per_s": INT8_NEW_TOKENS / gen_s,
                "int8_argmax_agree": agree, "int8_linear_max_abs_err": lin_err,
                "int8_peak_gb": peak}
    finally:
        httpd.shutdown()
        httpd.server_close()
        isset.close()
        _free(qserver)
        _memory("int8 server freed", on_card)


def write_lora_adapter(adapter_dir: str, cfg, r: int = LORA_R, alpha: int = LORA_ALPHA,
                       seed: int = 0) -> list[str]:
    """A PEFT adapter (bf16 safetensors and adapter_config.json) on q_proj
    and v_proj of every layer; returns the target weight names."""
    import torch

    from modelx_tpu_torch.dl import safetensors as st

    gen = torch.Generator().manual_seed(seed)
    e = cfg.hidden_size
    outs = {"q_proj": cfg.num_heads * cfg.head_dim, "v_proj": cfg.num_kv_heads * cfg.head_dim}
    tensors, targets = {}, []
    for i in range(cfg.num_layers):
        for proj, out in outs.items():
            base = f"model.layers.{i}.self_attn.{proj}"
            targets.append(base + ".weight")
            tensors[f"base_model.model.{base}.lora_A.weight"] = (
                torch.randn(r, e, generator=gen) / math.sqrt(e)).to(torch.bfloat16)
            tensors[f"base_model.model.{base}.lora_B.weight"] = (
                torch.randn(out, r, generator=gen) * 0.01).to(torch.bfloat16)
    os.makedirs(adapter_dir, exist_ok=True)
    st.write_safetensors(os.path.join(adapter_dir, "adapter_model.safetensors"), tensors)
    with open(os.path.join(adapter_dir, "adapter_config.json"), "w") as f:
        json.dump({"peft_type": "LORA", "r": r, "lora_alpha": alpha,
                   "target_modules": list(outs)}, f)
    return targets


def options_lora(cfg, ckpt: str, per_forward: int, device: str) -> dict:
    """``--lora``: serve the checkpoint with a written adapter merged; two
    targets against a manual merge by the same rule, bit for bit, and the
    kernel's launches on ``/v1/forward``."""
    import torch

    from modelx_tpu_torch.dl import safetensors as st
    from modelx_tpu_torch.dl import serve_main
    from modelx_tpu_torch.ops import attention as attn

    adapter = os.path.join(ckpt, "adapter")
    targets = write_lora_adapter(adapter, cfg)
    lport = _free_port()
    lsset, httpd = serve_main.start([
        "--model", f"lora={ckpt}", "--lora", f"lora={adapter}", "--listen",
        f"127.0.0.1:{lport}", "--device", device, "--dtype", "bfloat16"])
    lserver = lsset.servers["lora"]
    try:
        peak = _memory("LoRA server loaded (the main server freed)", device == "cuda")
        merge_s = lserver.stats["lora_merge_seconds"]
        checked = [targets[0], targets[-1]]
        base = st.read_tensors(os.path.join(ckpt, "model.safetensors"), want=checked.__contains__)
        ab = st.read_tensors(os.path.join(adapter, "adapter_model.safetensors"))
        for name in checked:
            stem = "base_model.model." + name.removesuffix(".weight")
            a = ab[stem + ".lora_A.weight"].float().numpy()
            b = ab[stem + ".lora_B.weight"].float().numpy()
            delta = torch.from_numpy(LORA_ALPHA / LORA_R * (b @ a)).to(torch.bfloat16)
            manual = base[name].to(lserver.device) + delta.to(lserver.device)
            if not torch.equal(manual.view(torch.int16), lserver.params[name].view(torch.int16)):
                raise RuntimeError(f"LoRA {name}: the served weight differs from a manual merge")
        gen = torch.Generator().manual_seed(10)
        tokens = torch.randint(0, cfg.vocab_size, (1, 512), generator=gen).tolist()
        before = attn.flash_attention.launches
        status, got = _http(lport, "/v1/forward", {"tokens": tokens})
        rose = attn.flash_attention.launches - before
        if status != 200 or rose != per_forward:
            raise RuntimeError(f"LoRA /v1/forward answered {status}, kernel launches {rose}, "
                               f"want {per_forward}")
        log(f"options: LoRA r {LORA_R} alpha {LORA_ALPHA} on q_proj and v_proj of "
            f"{cfg.num_layers} layers merged in {merge_s:.3f} s; {checked} equal a manual merge "
            f"bit for bit; /v1/forward [1, 512] 200, flash_attention launches +{rose}")
        return {"lora_merge_s": merge_s, "lora_peak_gb": peak}
    finally:
        httpd.shutdown()
        httpd.server_close()
        _free(lserver)


# -- phase 7: the registry deploy path ------------------------------------------------

DEPLOY_REPO = "library/llama3-8b"
DEPLOY_YAML = """description: Llama-3-8B-shaped random weights (chip smoke)
framework: pytorch
modelFiles:
- model.safetensors
- tokenizer.json
serving:
  model_family: llama
  dtype: bfloat16
"""
# a modelxdl-torch run in a fresh process, followed in that process by a
# tensor-by-tensor comparison of what it put on the device with dest's file
DL_CHILD = r"""
import json, os, sys, time
import torch
from modelx_tpu_torch.dl import dl_main, safetensors as st
from modelx_tpu_torch.dl.loader import LocalFileSource

summary = dl_main.run(sys.argv[1:])
arrays = summary["load"].pop("arrays")
t0 = time.monotonic()
bad, checked = [], 0
for name in sorted(os.listdir(summary["dest"])):
    if not name.endswith(".safetensors"):
        continue
    path = os.path.join(summary["dest"], name)
    infos, offset = st.read_header_from_file(path)
    src = LocalFileSource(path)
    try:
        for tname, info in infos.items():
            got = arrays.pop(tname).reshape(-1).view(torch.uint8)
            want = torch.from_numpy(src.read_range(offset + info.start, info.nbytes))
            checked += 1
            if not torch.equal(got, want.to(got.device)):
                bad.append(tname)
            del got, want
    finally:
        src.close()
summary["tensor_check"] = {"tensors": checked, "mismatched": bad, "not_in_dest": sorted(arrays),
                           "seconds": round(time.monotonic() - t0, 3)}
print(json.dumps(summary), flush=True)
"""


def _child_env() -> dict:
    """Children run from the checkout (``-c``/``-m`` put it on the path)."""
    env = dict(os.environ)
    env["MODELX_DL_NO_LOCAL_REDIRECT"] = "1"  # the bytes take HTTP and the cache tee
    return env


def _run_child(what: str, argv: list, timeout: float = 600.0) -> dict:
    """Run a child process from the checkout; its last stdout line is JSON."""
    t0 = time.monotonic()
    proc = subprocess.run(argv, cwd=REPO, env=_child_env(), capture_output=True, text=True,
                          timeout=timeout)
    secs = time.monotonic() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"deploy: {what} exited {proc.returncode}\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["process_seconds"] = round(secs, 3)
    return out


def _sha256_pass(path: str) -> tuple[str, float]:
    """The file's digest and the seconds its sha256 pass took."""
    from modelx_tpu_torch.types import Digest

    t0 = time.monotonic()
    return str(Digest.from_file(path)), time.monotonic() - t0


def write_registry(data_dir: str, ckpt: str) -> tuple[object, dict]:
    """The checkpoint, its tokenizer.json and tokenizer_config.json (left
    out by modelFiles) and a modelx.yaml, written into a local FS registry
    through the port's store API; the safetensors blob carries the
    tensor-index annotation. Returns (manifest, sha256 pass seconds)."""
    from modelx_tpu_torch.dl import safetensors as st
    from modelx_tpu_torch.registry.fs import LocalFSProvider
    from modelx_tpu_torch.registry.store import BlobContent
    from modelx_tpu_torch.registry.store_fs import FSRegistryStore
    from modelx_tpu_torch.types import (
        AnnotationTensorIndex, Descriptor, Manifest, MediaTypeModelConfigYaml,
        MediaTypeModelFile, MediaTypeModelManifestJson)

    with open(os.path.join(ckpt, "modelx.yaml"), "w") as f:
        f.write(DEPLOY_YAML)
    store = FSRegistryStore(LocalFSProvider(data_dir))
    hashed: dict = {}
    descs = []
    for name in ("model.safetensors", "tokenizer.json", "tokenizer_config.json", "modelx.yaml"):
        path = os.path.join(ckpt, name)
        digest, secs = _sha256_pass(path)
        hashed[name] = secs
        media = MediaTypeModelConfigYaml if name == "modelx.yaml" else MediaTypeModelFile
        desc = Descriptor(name=name, media_type=media, digest=digest,
                          size=os.path.getsize(path), mode=0o644)
        if name.endswith(".safetensors"):
            infos, offset = st.read_header_from_file(path)
            desc.annotations[AnnotationTensorIndex] = st.tensor_index_annotation(infos, offset)
        with open(path, "rb") as f:
            store.put_blob(DEPLOY_REPO, digest, BlobContent(f, desc.size, media))
        descs.append(desc)
    manifest = Manifest(config=descs[-1], blobs=descs[:-1])
    store.put_manifest(DEPLOY_REPO, "v1", MediaTypeModelManifestJson, manifest)
    return manifest, hashed


def _start_registry(data_dir: str, log_path: str):
    port = _free_port()
    log_f = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "modelx_tpu_torch.registry.server_main",
         "--listen", f"127.0.0.1:{port}", "--data", data_dir],
        cwd=REPO, env=_child_env(), stdout=log_f, stderr=subprocess.STDOUT)
    log_f.close()
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(f"deploy: the registry exited {proc.returncode}: "
                               f"{open(log_path).read()[-3000:]}")
        try:
            if _http_raw(port, "/healthz")[0] == 200:
                return proc, f"http://127.0.0.1:{port}"
        except OSError:
            pass
        time.sleep(0.2)
    proc.kill()
    raise RuntimeError("deploy: the registry did not answer /healthz in 120 s")


def _http_raw(port: int, path: str):
    """(status, headers, raw body) of a GET."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _deploy_disk(base: str, nbytes: int) -> None:
    """The registry, dest and the blob cache each hold the checkpoint once
    more (the checkpoint itself is already on the disk)."""
    import shutil

    free = shutil.disk_usage(base).free
    need = int(3 * nbytes * 1.02)
    log(f"deploy: {base} has {free / 1e9:.1f} GB free; the registry, dest and the blob "
        f"cache need {need / 1e9:.1f} GB beside the checkpoint")
    if free < need:
        raise RuntimeError(f"deploy: {(need - free) / 1e9:.1f} GB short of disk for the "
                           f"registry, dest and the blob cache")


def phase_deploy(cfg, ckpt: str, forwards: dict, device: str, per_forward: int,
                 artifacts=None, then=None) -> dict:
    """The registry deploy path (module docstring, phase 7). ``ckpt`` is
    deleted once the registry holds it; ``forwards`` maps each main-phase
    /v1/forward shape to (tokens, ``ckpt``'s argmax). With the deploy's server freed,
    ``artifacts(reg_dir, cache, dest, root, digest)`` runs on the registry's
    data and the warm blob cache; ``then(dest, root)`` runs last, with the
    registry and blob cache gone and the pulled checkpoint still in
    ``dest``. Their stats join the phase's."""
    import shutil
    import tempfile

    import torch

    from modelx_tpu_torch.client.remote import RegistryClient
    from modelx_tpu_torch.dl import manifest_cache, serve_main
    from modelx_tpu_torch.ops import attention as attn

    on_card = device == "cuda"
    nbytes = os.path.getsize(os.path.join(ckpt, "model.safetensors"))
    root = tempfile.mkdtemp(prefix="modelx-deploy-", dir=os.path.dirname(ckpt))
    stats: dict = {"deploy_bytes": nbytes}
    reg_dir, dest, cache = (os.path.join(root, d) for d in ("registry", "dest", "blob-cache"))
    registry = httpd = served = None
    t_deploy = time.monotonic()
    try:
        _deploy_disk(root, nbytes)
        t0 = time.monotonic()
        manifest, hashed = write_registry(reg_dir, ckpt)
        stats["deploy_registry_write_s"] = time.monotonic() - t0
        stats["sha256_s_registry_write"] = hashed["model.safetensors"]
        shutil.rmtree(ckpt)  # the registry holds it now: free its disk
        log(f"deploy: wrote {DEPLOY_REPO}@v1 into a local FS registry in "
            f"{stats['deploy_registry_write_s']:.1f} s (sha256 of the checkpoint "
            f"{hashed['model.safetensors']:.1f} s, {nbytes / hashed['model.safetensors'] / 1e9:.2f}"
            f" GB/s); deleted the source checkpoint")
        registry, base = _start_registry(reg_dir, os.path.join(root, "registry.log"))
        ref = f"{base}/{DEPLOY_REPO}@v1"
        dl_argv = [sys.executable, "-c", DL_CHILD, ref, dest, "--device-put",
                   "--blob-cache-dir", cache] + ([] if on_card else ["--device", "cpu"])

        # cold: an empty blob cache, the bytes over HTTP
        cold = _run_child("cold modelxdl-torch", dl_argv)
        weights = [b for b in manifest.blobs if b.name.endswith(".safetensors")]
        check = cold["tensor_check"]
        if check["mismatched"] or check["not_in_dest"] or check["tensors"] == 0:
            raise RuntimeError(f"deploy: tensors on the device differ from dest's file: {check}")
        for blob in manifest.blobs:
            want = blob.name in ("model.safetensors", "tokenizer.json")
            path = os.path.join(dest, blob.name)
            if os.path.exists(path) != want:
                raise RuntimeError(f"deploy: modelFiles selection wrong for {blob.name}")
        load = cold["load"]
        if (load["transports"] != {"model.safetensors": "registry"}
                or load["network_bytes"] != load["bytes"] or cold["blob_cache"]["admitted"] != 1):
            raise RuntimeError(f"deploy: the cold load did not take HTTP and the cache tee: "
                               f"{load} {cold['blob_cache']}")
        stats.update(deploy_cold_pull_s=cold["pull_seconds"], deploy_cold_load_s=load["seconds"],
                     deploy_cold_gbps=load["gbps"], deploy_cold_transfer_gbps=load["transfer_gbps"],
                     deploy_cold_total_s=cold["total_seconds"],
                     deploy_cold_process_s=cold["process_seconds"],
                     deploy_cold_tensor_check_s=check["seconds"],
                     sha256_s_cold_admit=cold["blob_cache"]["admit_verify_seconds"])
        log(f"deploy: cold modelxdl-torch --device-put: {cold['bytes'] / 1e9:.3f} GB pulled in "
            f"{cold['pull_seconds']} s ({cold['pull']}; the file location, hashed inline), "
            f"registry->{device} {load['bytes'] / 1e9:.3f} GB in {load['seconds']} s = "
            f"{load['gbps']:.3f} GB/s over HTTP with the blob cache's admit sha256 "
            f"({cold['blob_cache']['admit_verify_seconds']:.1f} s), {load['transfer_gbps']:.3f} "
            f"GB/s for the transfer alone ({load['transfer_seconds']} s, "
            f"{load['network_bytes']} network bytes); blob cache {cold['blob_cache']}; "
            f"{check['tensors']} tensors on the device == dest's bytes ({check['seconds']} s)")

        # warm: the same command again. Its hash-skip re-hashes every file
        # of dest (Digest.from_file) and downloads any whose digest is not
        # its descriptor's: none downloaded and all up to date is the check
        # that dest's files hash to their digests
        warm = _run_child("warm modelxdl-torch", dl_argv)
        wload = warm["load"]
        if warm["pull"]["up_to_date"] != cold["pull"]["downloaded"]:
            raise RuntimeError(f"deploy: a pulled file does not hash to its descriptor's digest: "
                               f"the warm pull found {warm['pull']} after the cold pull's "
                               f"{cold['pull']}")
        stats["sha256_s_dest_verify"] = warm["pull_seconds"]
        if (warm["pull"]["downloaded"] or wload["network_bytes"]
                or warm["blob_cache"]["hits"] != len(weights)
                or warm["tensor_check"]["mismatched"]
                or wload["transports"] != {"model.safetensors": "cache"}):
            raise RuntimeError(f"deploy: the warm deploy touched the network: {warm}")
        stats.update(deploy_warm_pull_s=warm["pull_seconds"], deploy_warm_load_s=wload["seconds"],
                     deploy_warm_gbps=wload["gbps"], deploy_warm_transfer_gbps=wload["transfer_gbps"],
                     deploy_warm_total_s=warm["total_seconds"],
                     sha256_s_warm_hit=warm["blob_cache"]["hit_verify_seconds"])
        log(f"deploy: warm modelxdl-torch --device-put: pull {warm['pull_seconds']} s "
            f"({warm['pull']}: the hash-skip re-hashed dest, every file its digest), "
            f"registry->{device} "
            f"{wload['bytes'] / 1e9:.3f} GB in {wload['seconds']} s = {wload['gbps']:.3f} GB/s from "
            f"the blob cache with its re-verify sha256 "
            f"({warm['blob_cache']['hit_verify_seconds']:.1f} s), {wload['transfer_gbps']:.3f} "
            f"GB/s for the transfer alone, 0 network bytes; blob cache {warm['blob_cache']}")

        # deploy TTFT in fresh processes: cold (an emptied blob cache), then warm
        shutil.rmtree(cache)
        ttft_argv = [sys.executable, "-m", "modelx_tpu_torch.dl.ttft", base, DEPLOY_REPO,
                     "--blob-cache-dir", cache] + ([] if on_card else ["--device", "cpu"])
        ttfts = {}
        for kind in ("cold", "warm"):
            t = ttfts[kind] = _run_child(f"{kind} ttft", ttft_argv)
            if t["flash_launches"] != per_forward or t["warm_blobs"] != (kind == "warm"):
                raise RuntimeError(f"deploy: {kind} TTFT: flash_launches {t['flash_launches']} "
                                   f"(want {per_forward}), warm_blobs {t['warm_blobs']}")
            log(f"deploy: {kind} TTFT {t['ttft_ms']} ms: plan {t['plan_ms']}, load "
                f"{t['load_ms']} ({t['load_gbps']} GB/s; the transfer {t['transfer_ms']}, the "
                f"blob cache's sha256 the rest), kernel library thread "
                f"{t['kernel_thread_ms']} (join {t['kernel_join_ms']}), first token "
                f"{t['first_exec_ms']} ms; weights ready {t['weights_ready_ms']} ms; first token "
                f"{t['first_token']} with {t['flash_launches']} flash launches")
            stats.update({f"ttft_{kind}_{k}": t[k] for k in (
                "ttft_ms", "plan_ms", "load_ms", "transfer_ms", "kernel_join_ms",
                "first_exec_ms", "kernel_thread_ms", "weights_ready_ms", "load_gbps")})
        if ttfts["cold"]["first_token"] != ttfts["warm"]["first_token"]:
            raise RuntimeError("deploy: cold and warm TTFT answered different first tokens")

        # serve what was pulled: the deploy path's own kernel count from 0
        attn.flash_attention.launches = 0
        port = _free_port()
        sset, httpd = serve_main.start([
            "--model", f"{MODEL}={dest}", "--listen", f"127.0.0.1:{port}", "--device", device,
            "--dtype", "bfloat16", "--manifest-cache-dir", os.path.join(root, "manifests")])
        served = sset.servers[MODEL]
        log(f"deploy: modelx-serve-torch --model {MODEL}=<dest> up; load "
            f"{served.stats['load_seconds']} s at {served.stats['load_gbps']} GB/s")
        for shape, (tokens, want) in forwards.items():
            before = attn.flash_attention.launches
            status, body = _http(port, "/v1/forward", {"tokens": tokens.tolist()})
            rose = attn.flash_attention.launches - before
            if status != 200 or body["logits_argmax"] != want.tolist() or rose != per_forward:
                raise RuntimeError(f"deploy: /v1/forward {shape} on dest answered {status}, "
                                   f"launches {rose}, argmax equal to the source's: "
                                   f"{status == 200 and body['logits_argmax'] == want.tolist()}")
            log(f"deploy: /v1/forward {list(shape)} on dest == the source's argmax; "
                f"flash_attention launches +{rose}")
        status, body = _http(port, "/v1/forward", {"tokens": [[1, 2, 3, 4]]})
        if status != 200 or body["logits_argmax"][0][-1] != ttfts["cold"]["first_token"]:
            raise RuntimeError("deploy: the TTFT first token differs from the served dest's")
        client = RegistryClient(base)
        client.get_manifest(DEPLOY_REPO, "v1")  # pins the manifest
        status, body = _http(port, "/healthz")
        if status != 200 or body.get("control_plane", {}).get("state") != "ok":
            raise RuntimeError(f"deploy: /healthz before the registry kill: {status} {body}")
        registry.kill()
        registry.wait(timeout=60)
        client.close()
        client.get_manifest(DEPLOY_REPO, "v1")  # served from the pinned manifest
        status, body = _http(port, "/healthz")
        state = body.get("control_plane", {}).get("state")
        if status != 200 or state in (None, "ok") or client.last_source != "cache":
            raise RuntimeError(f"deploy: /healthz after the registry kill: {status} {body}")
        log(f"deploy: registry killed: /healthz 200 with control_plane {state} "
            f"({body['control_plane']}); the pinned manifest served the re-resolve")
        stats["flash_launches_deploy_serve"] = attn.flash_attention.launches
        stats["flash_launches_deploy"] = (attn.flash_attention.launches
                                          + sum(t["flash_launches"] for t in ttfts.values()))
        if on_card:
            stats["deploy_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        manifest_cache.configure_default("")
        stats["deploy_phase_s"] = time.monotonic() - t_deploy
        log(f"deploy: the phase took {stats['deploy_phase_s']:.1f} s (the later phases "
            f"follow on its data)")
        if then is not None or artifacts is not None:
            httpd.shutdown()
            httpd.server_close()
            httpd = None
            _free(served)
            registry.kill()
            registry.wait(timeout=60)
            if artifacts is not None:
                stats.update(artifacts(reg_dir, cache, dest, root, weights[0].digest))
            shutil.rmtree(reg_dir, ignore_errors=True)
            shutil.rmtree(cache, ignore_errors=True)
            if then is not None:
                stats.update(then(dest, root))
        return stats
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
            _free(served)
        if registry is not None and registry.poll() is None:
            registry.kill()
            registry.wait(timeout=60)
        shutil.rmtree(root, ignore_errors=True)


# -- the artifacts phase: the derived-artifact stores -------------------------------

# the shared prompt heads the pods make hot, and each answer's length
ART_BASE_LEN = 1000
ART_NEW_TOKENS = 16
# temperature only, as the continuous phase's sampled rows
ART_SAMPLED = {"temperature": 0.8, "seed": 13}
# how long a publish, a sweep (every 5 s) or a fetch-through may take to land
ART_DEADLINE_S = 120.0
# extra environment for the two pods (empty on the card; the CPU rehearsal
# paces its tiny model's engine through MODELX_FAULT_PLAN, so a stream is
# still running when the router sees its pod drain)
ART_POD_ENV: dict = {}


def _artifacts_disk(base: str, nbytes: int) -> None:
    """Two pods each pull the checkpoint into their own staging dir."""
    import shutil

    free = shutil.disk_usage(base).free
    need = int(2 * nbytes * 1.02)
    log(f"artifacts: {base} has {free / 1e9:.1f} GB free; two staging copies need "
        f"{need / 1e9:.1f} GB")
    if free < need:
        raise RuntimeError(f"artifacts: {(need - free) / 1e9:.1f} GB short of disk for the "
                           f"two pods' staging copies")


def _no_toolkit_env(root: str) -> dict:
    """An environment with no CUDA toolkit in reach: a kernel build would
    fail for want of nvcc."""
    path = os.pathsep.join(p for p in os.environ.get("PATH", "").split(os.pathsep)
                           if p and not os.path.exists(os.path.join(p, "nvcc")))
    return {"CUDA_HOME": os.path.join(root, "no-cuda-toolkit"), "PATH": path}


def _art_pod(what: str, root: str, boot: str, device: str, env: dict, flags: list):
    """An artifacts pod: a ``_serve_child`` booting the tiny ``boot`` model
    with ``--allow-admin-load``; (process, port, log path)."""
    port = _free_port()
    proc, log_path = _serve_child(
        boot, device, port, root, name="boot", what=f"artifacts: pod {what}",
        extra=("--allow-admin-load", "--staging-dir", os.path.join(root, f"staging-{what}"),
               *flags), env={**ART_POD_ENV, **env})
    return proc, port, log_path


def _art_generate(port: int, prompt: list, stream: bool, **samp) -> tuple[bytes, float]:
    """The raw body of a /v1/MODEL/generate, whole or NDJSON, and the
    seconds to its first line (client side)."""
    import urllib.request

    body = {"tokens": [prompt], "max_new_tokens": ART_NEW_TOKENS, **samp}
    if stream:
        body["stream"] = True
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/{MODEL}/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=600) as r:
        first = r.readline()
        first_s = time.monotonic() - t0
        raw = first + r.read()
    if stream:
        _stream_tokens(raw)  # whole, with its done line
    return raw, first_s


def _answers(port: int, prompt: list) -> dict:
    """Greedy and seeded sampled answers to ``prompt``, whole and streamed."""
    return {(kind, stream): _art_generate(port, prompt, stream, **samp)[0]
            for kind, samp in (("greedy", {}), ("sampled", ART_SAMPLED))
            for stream in (False, True)}


def _admin_json(port: int) -> dict:
    status, body = _http(port, "/admin/models")
    if status != 200:
        raise RuntimeError(f"artifacts: /admin/models answered {status} {body}")
    return body


def _model_stats(port: int) -> dict:
    status, body = _http(port, "/v1/models")
    if status != 200:
        raise RuntimeError(f"artifacts: /v1/models answered {status} {body}")
    return body["models"][MODEL]


def _pool_events(port: int, event: str) -> list:
    status, body = _http(port, "/debug/flightrec")
    if status != 200:
        raise RuntimeError(f"artifacts: /debug/flightrec answered {status}")
    return [e for e in body["pool"]["events"] if e["event"] == event]


def _installed_admits(port: int) -> int:
    """The engine's admissions that decoded from installed KV (its
    ``dispatch_admit`` events marked ``installed_kv``)."""
    status, body = _http(port, "/debug/flightrec")
    if status != 200 or MODEL not in body:
        raise RuntimeError(f"artifacts: no engine ring for {MODEL}: {status}")
    return sum(1 for e in body[MODEL]["events"]
               if e["event"] == "dispatch_admit" and e.get("installed_kv"))


def _wait_for(what: str, fn, samples: list | None = None, outbox_port: int = 0):
    """Poll ``fn`` until it returns a true value (within ``ART_DEADLINE_S``);
    with ``outbox_port`` each poll also records the pod's outbox depth."""
    t0 = time.monotonic()
    while True:
        if outbox_port and samples is not None:
            ob = _admin_json(outbox_port)["pool"].get("outbox", {})
            samples.append((round(time.monotonic() - t0, 2), ob.get("depth")))
        got = fn()
        if got:
            return got, time.monotonic() - t0
        if time.monotonic() - t0 > ART_DEADLINE_S:
            raise RuntimeError(f"artifacts: {what} did not happen in {ART_DEADLINE_S} s")
        time.sleep(0.5)


def _manifest_blobs(base: str, media: str) -> list:
    from modelx_tpu_torch.client.remote import RegistryClient

    client = RegistryClient(base)
    try:
        return [b for b in client.get_manifest(DEPLOY_REPO, "v1").blobs if b.media_type == media]
    finally:
        client.close()


def _blob(base: str, desc) -> bytes:
    from modelx_tpu_torch.client.remote import RegistryClient

    client = RegistryClient(base)
    try:
        return b"".join(client.get_blob_content(DEPLOY_REPO, desc.digest))
    finally:
        client.close()


def _check_kv_layout(cfg, data: bytes, n_tokens: int) -> dict:
    """The KV bundle is the family's cache of the stored length: num_layers
    x (K, V) leaves of [1, stored_len, kv heads, head_dim] bf16, and the tar
    adds only its headers and padding to them and the meta."""
    import hashlib
    import io
    import tarfile

    from modelx_tpu_torch.dl import kv_store
    from modelx_tpu_torch.models.decode import pad_seq_len

    meta = kv_store._bundle_meta(data)
    stored = meta["storedLen"]
    shape = [1, stored, cfg.num_kv_heads, cfg.head_dim]
    leaf_bytes = cfg.num_layers * 2 * stored * cfg.num_kv_heads * cfg.head_dim * 2
    leaves = meta["leaves"]
    if (stored != pad_seq_len(n_tokens) or len(leaves) != 2 * cfg.num_layers
            or any(x["shape"] != shape or x["dtype"] != "bfloat16" for x in leaves)
            or sum(x["size"] for x in leaves) != leaf_bytes):
        raise RuntimeError(f"artifacts: the KV bundle's leaves are not the layout: stored "
                           f"{stored}, {len(leaves)} leaves, first {leaves[0]}")
    with tarfile.open(fileobj=io.BytesIO(data), mode="r:") as tar:
        names = tar.getnames()
        meta_len = tar.getmember("meta.json").size
        for x in leaves:
            raw = tar.extractfile(x["name"]).read()
            if hashlib.sha256(raw).hexdigest() != x["sha256"]:
                raise RuntimeError(f"artifacts: KV leaf {x['name']} does not hash to its meta")
    overhead = len(data) - leaf_bytes - meta_len
    bound = 2 * 512 * len(names) + 10240  # a header and padding per member, the end record
    if names[0] != "meta.json" or not 0 <= overhead <= bound:
        raise RuntimeError(f"artifacts: the KV tar is {len(data)} bytes for {leaf_bytes} of "
                           f"leaves and {meta_len} of meta (overhead {overhead} > {bound})")
    return {"stored_len": stored, "leaf_bytes": leaf_bytes, "meta_bytes": meta_len,
            "overhead": overhead}


def phase_artifacts(cfg, reg_dir: str, cache: str, dest: str, root: str, digest: str,
                    forwards: dict, device: str, per_forward: int, build_s: float | None) -> dict:
    """The derived-artifact stores (module docstring, phase 8): two pods on
    the deploy phase's registry and warm blob cache. Pod A publishes the
    kernel library and a hot prefix's KV; pod B, with an empty build
    directory and no CUDA toolkit in reach, installs both at its admin load
    and fetches a second prefix through. ``dest``'s weights are moved aside
    for the two staging copies and come back from the blob cache after."""
    import dataclasses
    import hashlib
    import shutil

    import torch

    from modelx_tpu_torch.dl import blob_cache, kv_store, program_store
    from modelx_tpu_torch.dl import safetensors as st
    from modelx_tpu_torch.kernels import build
    from modelx_tpu_torch.models import gpt2
    from modelx_tpu_torch.types import MediaTypeModelKVCache, MediaTypeModelProgram

    on_card = device == "cuda"
    weights = os.path.join(dest, "model.safetensors")
    nbytes = os.path.getsize(weights)
    cached = blob_cache.BlobCache(cache).entry_path(digest)
    if not os.path.isfile(cached):
        raise RuntimeError("artifacts: the blob cache lost the checkpoint")
    os.unlink(weights)  # the blob cache holds the same bytes
    stats: dict = {}
    registry = pod_a = pod_b = None
    try:
        _artifacts_disk(root, nbytes)
        registry, base = _start_registry(reg_dir, os.path.join(root, "registry-artifacts.log"))
        ref = f"{base}/{DEPLOY_REPO}@v1"
        # the pods' boot model: serve_main needs one, and gpt2's plain
        # attention launches no kernel, so nothing binds the library before
        # the admin load
        boot = os.path.join(root, "boot-gpt2")
        os.makedirs(boot)
        tiny = dataclasses.replace(gpt2.GPT2Config.tiny(), dtype=torch.bfloat16)
        st.write_safetensors(os.path.join(boot, "model.safetensors"),
                             gpt2.init_params(tiny, torch.Generator().manual_seed(0)))
        rng = torch.Generator().manual_seed(10)

        def draw(n):
            return torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()

        bases = [draw(ART_BASE_LEN), draw(ART_BASE_LEN)]
        branches = [[b + draw(2) for _ in range(5)] for b in bases]
        env_a = {}
        if on_card:
            library = build.library_path()  # phase 2's
        else:
            # no nvcc here: a stand-in file under the library's name
            env_a["MODELX_COMPILE_CACHE"] = os.path.join(root, "build-a")
            os.makedirs(env_a["MODELX_COMPILE_CACHE"])
            library = os.path.join(env_a["MODELX_COMPILE_CACHE"], build.library_name())
            with open(library, "wb") as f:
                f.write(b"a stand-in kernel library (CPU rehearsal)")
        with open(library, "rb") as f:
            library_sha = hashlib.sha256(f.read()).hexdigest()
        outbox = os.path.join(root, "outbox")

        # (a) pod A loads and publishes
        pod_a, port_a, log_a = _art_pod("a", root, boot, device, env_a, [
            "--publish-kv", "--kv-publish-threshold", "2", "--publish-programs",
            "--publish-outbox-dir", outbox, "--blob-cache-dir", cache,
            "--access-log", os.path.join(root, "access-a.jsonl")])
        t0 = time.monotonic()
        status, body = _http(port_a, "/admin/models", {"name": MODEL, "ref": ref, "wait": True})
        load_a = time.monotonic() - t0
        if status != 200 or body[MODEL]["state"] != "READY":
            raise RuntimeError(f"artifacts: pod A's admin load answered {status} {body}")
        depth: list = []
        progs, _ = _wait_for("the program bundle's publish",
                             lambda: _manifest_blobs(base, MediaTypeModelProgram), depth, port_a)
        (prog,) = progs
        members = program_store._bundle_meta(_blob(base, prog))["artifacts"]
        if [m["sha256"] for m in members] != [library_sha]:
            raise RuntimeError(f"artifacts: the program bundle's library is not phase 2's: "
                               f"{members}")
        # the outbox records its drained event just after the manifest lands
        events, _ = _wait_for("the outbox's drained event", lambda: [
            e for e in _pool_events(port_a, "outbox.drained") if e["kind"] == "programs"])
        (drained,) = events
        stats.update(art_program_bytes=prog.size, art_program_publish_s=drained["seconds"],
                     art_load_a_s=load_a)
        log(f"artifacts: pod A admin-loaded {DEPLOY_REPO}@v1 in {load_a:.2f} s and published "
            f"{prog.name} ({prog.size} bytes; its library hashes equal to "
            f"{'phase 2' if on_card else 'the stand-in'}'s) through the outbox in "
            f"{drained['seconds']:.3f} s ({CARD})")

        for prompt in [bases[0]] + branches[0][:2]:
            _art_generate(port_a, prompt, False)
        kvs, waited = _wait_for(
            "the KV publish",
            lambda: (_admin_json(port_a)["serving"][MODEL]["prefix_cache"]["published_total"]
                     >= 1 and _manifest_blobs(base, MediaTypeModelKVCache)), depth, port_a)
        (kv_desc,) = kvs
        layout = _check_kv_layout(cfg, _blob(base, kv_desc), ART_BASE_LEN)
        (enq,) = _pool_events(port_a, "kv.publish_enqueued")
        (kv_drained,) = [e for e in _pool_events(port_a, "outbox.drained")
                         if e["kind"] == "kvcache"]
        stats.update(art_kv_bytes=kv_desc.size, art_kv_build_ms=enq["build_ms"],
                     art_kv_publish_s=kv_drained["seconds"], art_kv_published_after_s=waited,
                     art_kv_stored_len=layout["stored_len"])
        log(f"artifacts: pod A: {ART_BASE_LEN}-token base, two branches: {kv_desc.name} "
            f"published {waited:.1f} s after the last request ({kv_desc.size} bytes = "
            f"{layout['leaf_bytes']} of leaves ({cfg.num_layers} x 2 x {layout['stored_len']} x "
            f"{cfg.num_kv_heads} x {cfg.head_dim} x 2 B) + {layout['meta_bytes']} meta + "
            f"{layout['overhead']} tar); built in {enq['build_ms']:.1f} ms, published in "
            f"{kv_drained['seconds']:.3f} s ({CARD})")
        want = _answers(port_a, branches[0][2])
        tokens, argmax = forwards[FORWARD_SHAPES[0]]
        if _argmax(port_a, MODEL, tokens) != argmax.tolist():
            raise RuntimeError("artifacts: pod A's /v1/forward differs from the source's")

        # (b) pod B: an empty build dir, no toolkit; installs at its load
        build_b = os.path.join(root, "build-b")
        os.makedirs(build_b)
        pod_b, port_b, log_b = _art_pod("b", root, boot, device, {
            "MODELX_COMPILE_CACHE": build_b, **_no_toolkit_env(root)}, [
            "--kv-fetch-through", "--blob-cache-dir", cache,
            "--access-log", os.path.join(root, "access-b.jsonl")])
        t0 = time.monotonic()
        status, body = _http(port_b, "/admin/models", {"name": MODEL, "ref": ref, "wait": True})
        load_b = time.monotonic() - t0
        if status != 200 or body[MODEL]["state"] != "READY":
            raise RuntimeError(f"artifacts: pod B's admin load answered {status} {body}")
        ms = _model_stats(port_b)
        programs, kv, lib = ms.get("programs", {}), ms.get("kv", {}), ms.get("kernel_library")
        if programs.get("installed", 0) < 1 or programs.get("skipped") or kv.get(
                "installed", 0) < 1 or kv.get("skipped"):
            raise RuntimeError(f"artifacts: pod B installed programs {programs}, kv {kv}")
        if on_card and (lib is None or lib["origin"] != "bundle" or lib["nvcc_seconds"]):
            raise RuntimeError(f"artifacts: pod B's kernel library came from {lib}")
        with open(os.path.join(build_b, build.library_name()), "rb") as f:
            if hashlib.sha256(f.read()).hexdigest() != library_sha:
                raise RuntimeError("artifacts: pod B's installed library is not pod A's")
        if _argmax(port_b, MODEL, tokens) != argmax.tolist():
            raise RuntimeError("artifacts: pod B's /v1/forward differs from the source's")
        stats.update(art_load_b_s=load_b, art_ready_b_s=ms["ready_seconds"],
                     art_program_install_ms=programs["ms"], art_kv_install_ms=kv["ms"],
                     art_nvcc_s=build_s)
        log(f"artifacts: pod B (MODELX_COMPILE_CACHE empty, no nvcc in reach) admin-loaded in "
            f"{load_b:.2f} s, ready {ms['ready_seconds']} s with the library from "
            f"{(lib or {}).get('origin', 'no card')} (installed in {programs['ms']} ms; phase 2's "
            f"nvcc build: {'cached' if build_s is None else f'{build_s:.3f} s'}); "
            f"{kv['installed']} KV bundle installed in {kv['ms']} ms; /v1/forward "
            f"{list(tokens.shape)} == the source's argmax ({CARD})")

        _art_generate(port_b, [1, 2, 3], False)  # the engine starts outside the timing
        got = _answers(port_b, branches[0][2])
        if got != want:
            bad = [k for k in want if got[k] != want[k]]
            raise RuntimeError(f"artifacts: pod B's answers from the installed prefix differ "
                               f"from pod A's: {bad}")
        _, ttft_hit = _art_generate(port_b, branches[0][3], True)
        _, ttft_cold = _art_generate(port_b, draw(ART_BASE_LEN + 2), True)
        last_miss = time.monotonic()
        pc = _admin_json(port_b)["serving"][MODEL]["prefix_cache"]
        admits = _installed_admits(port_b)
        if pc["hits_installed"] < 1 or admits < 1:
            raise RuntimeError(f"artifacts: pod B decoded from no installed entry: {pc}, "
                               f"{admits} admissions")
        stats.update(art_ttft_installed_ms=ttft_hit * 1e3, art_ttft_cold_ms=ttft_cold * 1e3,
                     art_hits_installed=pc["hits_installed"], art_installed_admits=admits)
        log(f"artifacts: pod B answers base+[e,f] greedy and sampled, whole and streamed, "
            f"byte for byte as pod A; hits_installed {pc['hits_installed']}, "
            f"prefix_hits_installed {admits}; first streamed token {ttft_hit * 1e3:.1f} ms "
            f"on the installed prefix against {ttft_cold * 1e3:.1f} ms for "
            f"{ART_BASE_LEN + 2} tokens with no prefix ({CARD})")

        # (c) fetch-through: pod A makes a second prefix hot after pod B is up
        for prompt in [bases[1]] + branches[1][:2]:
            _art_generate(port_a, prompt, False)
        _wait_for("the second KV publish",
                  lambda: len(_manifest_blobs(base, MediaTypeModelKVCache)) >= 2, depth, port_a)
        want2 = _art_generate(port_a, branches[1][3], False)[0]
        # the fetcher keeps a manifest read for MANIFEST_TTL_S: let the one
        # its last miss read (before this publish) expire first
        time.sleep(max(0.0, last_miss + kv_store.KVFetcher.MANIFEST_TTL_S + 0.5
                       - time.monotonic()))
        _art_generate(port_b, branches[1][2], False)  # a miss: the fetcher hears of it

        def fetched():
            f = _admin_json(port_b)["pool"].get("kv_fetchers", {}).get(MODEL, {})
            return f if f.get("installed_total", 0) >= 1 else None

        fetch, fetch_s = _wait_for("the fetch-through install", fetched)
        before = _admin_json(port_b)["serving"][MODEL]["prefix_cache"]["hits_installed"]
        if _art_generate(port_b, branches[1][3], False)[0] != want2:
            raise RuntimeError("artifacts: pod B's answer from the fetched prefix differs from "
                               "pod A's")
        after = _admin_json(port_b)["serving"][MODEL]["prefix_cache"]["hits_installed"]
        if after <= before:
            raise RuntimeError("artifacts: pod B's request after the fetch did not hit it")
        stats.update(art_fetch_install_ms=fetch["install_ms_total"], art_fetch_after_s=fetch_s,
                     art_outbox_depth=depth)
        log(f"artifacts: fetch-through: pod B's miss installed the second prefix in "
            f"{fetch['install_ms_total']:.1f} ms ({fetch_s:.1f} s after the miss); the next "
            f"request hit it and answered pod A's tokens ({CARD})")
        log(f"artifacts: pod A's outbox depth (seconds into each wait, depth): {depth}")

        # each pod: the admin load's warm-up and one /v1/forward [1, 2048]
        launches_a = _pod_launches_now(pod_a, log_a, "artifacts: pod A")
        launches_b = _pod_launches_now(pod_b, log_b, "artifacts: pod B")
        if launches_a != 2 * per_forward or launches_b != 2 * per_forward:
            raise RuntimeError(f"artifacts: flash launches A {launches_a}, B {launches_b}, want "
                               f"{2 * per_forward} each")
        stats["flash_launches_artifacts"] = launches_a + launches_b

        # (d) the fleet router in front of both pods; it stops them itself
        pods = {port_a: (pod_a, log_a, launches_a, "access-a.jsonl"),
                port_b: (pod_b, log_b, launches_b, "access-b.jsonl")}
        stats.update(phase_router(cfg, pods, tokens, draw, cached, root, device, per_forward))
        pod_a = pod_b = None
        return stats
    finally:
        for pod in (pod_a, pod_b):
            if pod is not None and pod.poll() is None:
                pod.kill()
                pod.wait(timeout=60)
        if registry is not None and registry.poll() is None:
            registry.kill()
            registry.wait(timeout=60)
        for d in ("staging-a", "staging-b"):
            shutil.rmtree(os.path.join(root, d), ignore_errors=True)
        os.replace(cached, weights)  # dest whole again for the phases after


# -- phase 8 (d): the fleet router in front of the artifacts pods ---------------------

ROUTER_POLL_S = 0.25
ROUTER_FORWARDS = 5
ROUTER_BRANCH_TOKENS = 32
ROUTER_STREAM_TOKENS = 96
ROUTER_HANDOFF_AFTER = 8
ROUTER_SAMPLED = {"temperature": 0.8, "seed": 23}
ROUTER_TEXT = "The router relays the stream of the pod that serves it, chunk for chunk"


def _pod_launches_now(proc, log_path: str, what: str) -> int:
    """A ``_serve_child``'s flash launches so far: it prints the count on
    SIGUSR1 (``SERVE_CHILD``)."""
    import signal

    def counts():
        with open(log_path) as f:
            return re.findall(r"^FLASH_LAUNCHES_NOW (\d+)$", f.read(), re.M)

    seen = len(counts())
    proc.send_signal(signal.SIGUSR1)
    deadline = time.monotonic() + 60
    while len(counts()) <= seen:
        if proc.poll() is not None or time.monotonic() > deadline:
            raise RuntimeError(f"{what}: no launch count on SIGUSR1 (exit {proc.poll()})")
        time.sleep(0.05)
    return int(counts()[-1])


def _router_metrics(rport: int) -> dict:
    status, _, raw = _http_raw(rport, "/metrics")
    if status != 200:
        raise RuntimeError(f"router: /metrics answered {status}")
    return json.loads(raw)


def _routed(rport: int, before: dict) -> str:
    """The one pod URL whose ``routes`` count rose since ``before``."""
    after = _router_metrics(rport)["router"]["routes"]
    rose = [u for u in after if after[u] > before.get(u, 0)]
    if len(rose) != 1:
        raise RuntimeError(f"router: routes {before} -> {after}: want one pod to rise")
    return rose[0]


def _sse_masked(raw: bytes) -> list:
    """SSE events with the per-request ``id`` and ``created`` masked."""
    out = []
    for chunk in raw.decode().split("\n\n")[:-1]:
        data = chunk[len("data: "):]
        if data == "[DONE]":
            out.append(data)
            continue
        ev = json.loads(data)
        out.append({k: (None if k in ("id", "created") else v) for k, v in ev.items()})
    return out


def _stream_via(port: int, path: str, body: dict, headers: dict, on_token=None):
    """A native NDJSON stream read line by line: (raw bytes, token ids, each
    token's arrival in seconds since the request, the done line seen, the
    request's start on the wall clock)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        t0, t0_wall = time.monotonic(), time.time()
        conn.request("POST", path, body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json", **headers})
        resp = conn.getresponse()
        if resp.status != 200:
            raise RuntimeError(f"router: a stream answered {resp.status} {resp.read()[:300]}")
        raw, toks, times, done = b"", [], [], False
        while True:
            line = resp.readline()
            if not line:
                break
            raw += line
            obj = json.loads(line)
            if "error" in obj:
                raise RuntimeError(f"router: the stream carried {obj}")
            if obj == {"done": True}:
                done = True
                continue
            toks.extend(obj["tokens"][0])
            times.append(time.monotonic() - t0)
            if on_token is not None:
                on_token(len(toks))
        return raw, toks, times, done, t0_wall
    finally:
        conn.close()


def _continuation(access_log: str, request_id: str) -> dict:
    """The access-log record of the continuation the pod served for
    ``request_id``: its engine timing carries the ``resume_step``."""
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if os.path.exists(access_log):
            with open(access_log) as f:
                for line in f:
                    rec = json.loads(line)
                    if (rec.get("request_id") == request_id
                            and (rec.get("timing") or {}).get("resume_step")):
                        return rec
        time.sleep(0.1)
    raise RuntimeError(f"router: no continuation of {request_id} in {access_log}")


def _tie_gaps(cfg, cached: str, root: str, device: str, prefix: list,
              candidates: tuple) -> tuple[float, dict]:
    """(top-2 margin, each candidate's distance below the maximum) of the
    plain path's logits for the token after ``prefix``: the checkpoint (the
    blob cache's entry) loaded in process, cache-free, with reference
    attention (a pod's /v1/forward answers the argmax only)."""
    import torch

    from modelx_tpu_torch.dl.serve import ModelServer
    from modelx_tpu_torch.models import llama

    tie_dir = os.path.join(root, "router-tie")
    os.makedirs(tie_dir, exist_ok=True)
    link = os.path.join(tie_dir, "model.safetensors")
    if not os.path.exists(link):
        os.symlink(cached, link)
    server = ModelServer(tie_dir, dtype="bfloat16", device=device, name=MODEL,
                         max_seq_len=len(prefix) + 16)
    try:
        _uncounted(server.load)
        with torch.inference_mode():
            tok = torch.tensor([prefix], dtype=torch.int64, device=server.device)
            logits = llama.forward(server.params, tok, server.cfg,
                                   attention_impl="reference")[0][0, -1].float()
        top = logits.topk(2).values
        return (float(top[0] - top[1]),
                {t: float(top[0] - logits[t]) for t in candidates})
    finally:
        _free(server)


def check_handoff(got: list, whole: list, k: int, tail: list, tail_done: bool,
                  gaps_at) -> str:
    """The handed-off stream ``got`` (continued at step ``k``) against the
    uninterrupted ``whole``: its tail must be ``tail``, the second pod's
    direct answer to the same resume block, and the whole must equal
    ``whole`` or first differ at a step ``j0`` where ``gaps_at(j0)`` gives
    a near tie: (the top-2 margin of the plain logits on the common prefix,
    each of the two tokens' distance below their maximum), all within
    ``MARGIN_TOL`` (the main phase's rule, which lets the kernel and the
    plain path disagree where the top-2 margin is within it). Returns which
    held; raises otherwise."""
    if not 0 < k < len(whole) or got[k:] != tail or not tail_done:
        raise RuntimeError(f"router: the stream's tail after step {k} differs from the "
                           f"second pod's direct answer to the same resume headers")
    if got == whole:
        return "equal to the uninterrupted stream"
    if len(got) != len(whole):
        raise RuntimeError(f"router: {len(got)} tokens, the uninterrupted stream {len(whole)}")
    j0 = next(i for i, (a, b) in enumerate(zip(got, whole)) if a != b)
    margin, gaps = gaps_at(j0)
    if margin > MARGIN_TOL or max(gaps.values()) > MARGIN_TOL:
        raise RuntimeError(f"router: the handed-off stream first differs at step {j0} "
                           f"({got[j0]} vs {whole[j0]}): top-2 margin {margin:.4f}, the two "
                           f"tokens {gaps} below the maximum (tolerance {MARGIN_TOL})")
    return (f"first different from the uninterrupted stream at step {j0} ({got[j0]} vs "
            f"{whole[j0]}), a near tie: top-2 margin {margin:.4f}, the two tokens "
            + ", ".join(f"{g:.4f}" for g in gaps.values())
            + f" below the maximum on their prefix (tolerance {MARGIN_TOL})")


def phase_router(cfg, pods: dict, tokens, draw, cached: str, root: str, device: str,
                 per_forward: int) -> dict:
    """Phase 8 (d), module docstring: ``pods`` maps each artifacts pod's
    port to (process, log, its launches before this path, access log).
    Stops both pods (SIGTERM, as the phase always did) and the router."""
    import signal
    import threading

    t_path = time.monotonic()
    stats: dict = {}
    urls = {f"http://127.0.0.1:{p}": p for p in pods}
    rport = _free_port()
    rlog = os.path.join(root, "router.log")
    log_f = open(rlog, "w")
    t0 = time.monotonic()
    router = subprocess.Popen(
        [sys.executable, "-m", "modelx_tpu_torch.router.router_main",
         *[a for u in urls for a in ("--pod", u)], "--listen", f"127.0.0.1:{rport}",
         "--default-model", MODEL, "--poll-interval", str(ROUTER_POLL_S)],
        cwd=REPO, env=_child_env(), stdout=log_f, stderr=subprocess.STDOUT)
    log_f.close()
    stopped: dict = {}  # port -> the pod's total launches at its exit

    def stop_pod(port):
        proc, plog, _, _ = pods[port]
        stopped[port] = _stop_serve_child(proc, plog, f"router: pod {port}")

    try:
        healthz_s = None
        deadline = time.monotonic() + 120
        while True:
            if router.poll() is not None:
                raise RuntimeError(f"router: the router exited {router.returncode}: "
                                   f"{open(rlog).read()[-3000:]}")
            try:
                if healthz_s is None and _http_raw(rport, "/healthz")[0] == 200:
                    healthz_s = time.monotonic() - t0
                if healthz_s is not None:
                    table = _router_metrics(rport)["pods"]["pods"]
                    if all(table.get(u, {}).get("healthy") and
                           table[u]["models"].get(MODEL) == "READY" for u in urls):
                        break
            except OSError:
                pass
            if time.monotonic() > deadline:
                raise RuntimeError(f"router: the router did not reach both pods in 120 s: "
                                   f"{open(rlog).read()[-3000:]}")
            time.sleep(0.05)
        ready_s = time.monotonic() - t0
        with open(f"/proc/{router.pid}/maps") as f:
            torch_mapped = sorted({ln.split()[-1] for ln in f if "libtorch" in ln
                                   or "libc10" in ln})
        if torch_mapped:
            raise RuntimeError(f"router: the router process mapped torch: {torch_mapped}")
        stats.update(router_healthz_s=healthz_s, router_ready_s=ready_s)
        log(f"router: the router child answered /healthz 200 {healthz_s:.2f} s after spawn and "
            f"saw both pods READY at {ready_s:.2f} s; its address space maps no torch library")

        # the routed forward against the same body sent straight to its pod
        path = f"/v1/{MODEL}/forward"
        body = {"tokens": tokens.tolist()}
        routes = _router_metrics(rport)["router"]["routes"]
        counts = {p: _pod_launches_now(pods[p][0], pods[p][1], "router") for p in pods}
        status, _, via = _post(rport, path, body)
        url = _routed(rport, routes)
        fport = urls[url]
        rose = _pod_launches_now(pods[fport][0], pods[fport][1], "router") - counts[fport]
        status_d, _, direct = _post(fport, path, body)
        if status != 200 or status_d != 200 or via != direct:
            raise RuntimeError(f"router: the routed forward ({status}) differs from {url}'s "
                               f"direct answer ({status_d})")
        if rose != per_forward:
            raise RuntimeError(f"router: {url}'s launches rose {rose}, want {per_forward}")
        fwd_bytes = direct
        forwards = {fport: 2}
        hop = {"via": [], "direct": []}
        for _ in range(ROUTER_FORWARDS):
            for kind, port in (("via", rport), ("direct", fport)):
                t = time.monotonic()
                st_, _, out = _post(port, path, body)
                hop[kind].append((time.monotonic() - t) * 1e3)
                if st_ != 200 or out != direct:
                    raise RuntimeError(f"router: a repeated {kind} forward answered {st_} "
                                       f"and other bytes")
            forwards[fport] += 2
        med = {k: statistics.median(v) for k, v in hop.items()}
        stats.update(router_forward_ms=med["via"], direct_forward_ms=med["direct"],
                     router_hop_ms=med["via"] - med["direct"])
        log(f"router: /v1/forward {list(tokens.shape)} through the router == {url}'s direct "
            f"bytes; that pod's launches +{rose}; median of {ROUTER_FORWARDS}: routed "
            f"{med['via']:.2f} ms, direct {med['direct']:.2f} ms, the hop "
            f"{med['via'] - med['direct']:.2f} ms ({CARD})")

        # stickiness: two greedy branches of a fresh base land on one pod
        base = draw(ART_BASE_LEN)
        hits0 = _router_metrics(rport)["router"]["sticky_hits"]
        landed = []
        for extra in (draw(2), draw(2)):
            gen = {"tokens": [base + extra], "max_new_tokens": ROUTER_BRANCH_TOKENS}
            routes = _router_metrics(rport)["router"]["routes"]
            st_, _, via = _post(rport, f"/v1/{MODEL}/generate", gen)
            landed.append(_routed(rport, routes))
            st_d, _, direct = _post(urls[landed[-1]], f"/v1/{MODEL}/generate", gen)
            if st_ != 200 or via != direct:
                raise RuntimeError(f"router: a routed branch ({st_}) differs from "
                                   f"{landed[-1]}'s direct answer ({st_d})")
        hits = _router_metrics(rport)["router"]["sticky_hits"] - hits0
        if landed[0] != landed[1] or hits < 1:
            raise RuntimeError(f"router: two branches of one base landed on {landed} "
                               f"(sticky hits +{hits})")
        sticky_url = landed[0]
        log(f"router: two greedy {ROUTER_BRANCH_TOKENS}-token branches of a fresh "
            f"{ART_BASE_LEN}-token base both landed on {sticky_url} (sticky_hits +{hits}) and "
            f"equal its direct answers byte for byte")

        # streams relayed unchanged: seeded NDJSON and SSE completions
        for what, spath, sbody in (
                ("NDJSON", f"/v1/{MODEL}/generate",
                 {"tokens": [draw(64)], "max_new_tokens": ART_NEW_TOKENS, "stream": True,
                  **ROUTER_SAMPLED}),
                ("SSE", "/v1/completions",
                 {"model": MODEL, "prompt": ROUTER_TEXT, "max_tokens": ART_NEW_TOKENS,
                  "stream": True, **ROUTER_SAMPLED})):
            routes = _router_metrics(rport)["router"]["routes"]
            st_, hdrs, via = _post(rport, spath, sbody)
            served = _routed(rport, routes)
            st_d, _, direct = _post(urls[served], spath, sbody)
            same = (_sse_masked(via) == _sse_masked(direct) if what == "SSE"
                    else via == direct)
            if st_ != 200 or st_d != 200 or not same or len(via) < 40:
                raise RuntimeError(f"router: the {what} stream through the router ({st_}, "
                                   f"{len(via)} bytes) differs from {served}'s ({st_d})")
        log(f"router: a seeded NDJSON stream and an SSE /v1/completions stream equal the "
            f"serving pod's direct streams (SSE with id and created masked)")

        # the drain hand-off: SIGTERM the pod feeding a stream after 8 tokens
        prompt = base + draw(2)
        gen = {"tokens": [prompt], "max_new_tokens": ROUTER_STREAM_TOKENS, "stream": True}
        xport = urls[sticky_url]
        yport = next(p for p in pods if p != xport)
        _, whole, whole_times, _, _ = _stream_via(xport, f"/v1/{MODEL}/generate", gen, {})
        if len(whole) != ROUTER_STREAM_TOKENS:
            raise RuntimeError(f"router: the uninterrupted stream had {len(whole)} tokens")
        before = _router_metrics(rport)["router"]
        killer = threading.Thread(target=stop_pod, args=(xport,))

        def on_token(n):
            if n == ROUTER_HANDOFF_AFTER and not killer.is_alive() and xport not in stopped:
                killer.start()

        rid = "chip-smoke-handoff"
        raw, got, times, done, t0_wall = _stream_via(rport, f"/v1/{MODEL}/generate", gen,
                                                     {"X-ModelX-Request-Id": rid}, on_token)
        killer.join(timeout=180)
        if xport not in stopped:
            raise RuntimeError("router: the drained pod did not exit")
        after = _router_metrics(rport)["router"]
        moved = {k: after[k] - before[k] for k in ("drain_handoffs_total",
                                                   "streams_continued_total",
                                                   "severed_streams_total")}
        if (moved != {"drain_handoffs_total": 1, "streams_continued_total": 1,
                      "severed_streams_total": 0} or not done
                or len(got) != ROUTER_STREAM_TOKENS):
            raise RuntimeError(f"router: the hand-off counted {moved}; {len(got)} tokens, done "
                               f"line {done}")
        cont = _continuation(os.path.join(root, pods[yport][3]), rid)
        k = int(cont["timing"]["resume_step"])
        headers = {"X-ModelX-Resume-Emitted": ",".join(str(t) for t in got[:k]),
                   "X-ModelX-Resume-Seed": "0"}
        _, tail, tail_times, tail_done, _ = _stream_via(yport, f"/v1/{MODEL}/generate", gen,
                                                        headers)
        held = check_handoff(got, whole, k, tail, tail_done, lambda j0: _uncounted(
            lambda: _tie_gaps(cfg, cached, root, device, prompt + got[:j0],
                              (got[j0], whole[j0]))))
        gap_ms = (times[k] - times[k - 1]) * 1e3
        timing = {key: cont["timing"].get(key) for key in ("queue_ms", "prefill_ms", "ttft_ms")}
        # the gap split on the wall clock: until the continuation reached the
        # second pod (its access log's stamp less its duration), then its TTFT
        reached_ms = (cont["ts"] - cont["ms"] / 1e3 - (t0_wall + times[k - 1])) * 1e3
        # the first pod's own cadence: its uninterrupted stream's longest gap
        cadence_ms = max(b - a for a, b in zip(whole_times, whole_times[1:])) * 1e3
        stats.update(router_handoff_step=k, router_handoff_gap_ms=gap_ms,
                     router_handoff_held=held, router_continuation_timing=timing,
                     router_continuation_reached_ms=reached_ms,
                     router_first_pod_max_gap_ms=cadence_ms,
                     router_resume_direct_first_ms=tail_times[0] * 1e3)
        log(f"router: SIGTERM of the pod feeding a {ROUTER_STREAM_TOKENS}-token stream after "
            f"{ROUTER_HANDOFF_AFTER} tokens: the router handed it off at token {k} "
            f"(drain_handoffs +1, streams_continued +1, severed +0); the client got "
            f"{len(got)} tokens and one done line; the tail == the second pod's direct answer "
            f"to the same resume headers; {held}; the drained pod exited 0; {gap_ms:.1f} ms "
            f"from the first pod's last token to the second pod's first: the continuation "
            f"reached the second pod {reached_ms:.1f} ms after that token (the first pod's "
            f"uninterrupted stream had {cadence_ms:.1f} ms at most between two tokens), then "
            f"{timing} there (its access log); the same resume sent straight: first token "
            f"{tail_times[0] * 1e3:.1f} ms ({CARD})")

        # the fleet shrinks: one pod left, then none
        st_, _, out = _post(rport, path, body)
        if st_ != 200 or out != fwd_bytes:
            raise RuntimeError(f"router: a forward with one pod left answered {st_} and "
                               f"other bytes")
        forwards[yport] = forwards.get(yport, 0) + 1
        stop_pod(yport)
        st_, hdrs, out = _post(rport, path, body)
        if st_ != 503 or not hdrs.get("Retry-After") or b"no ready pod serves" not in out:
            raise RuntimeError(f"router: with no pod left the router answered {st_} "
                               f"{dict(hdrs)} {out[:200]}")
        log(f"router: with one pod gone a forward answered 200 from {yport}; with none, the "
            f"typed 503 with Retry-After {hdrs['Retry-After']}: {json.loads(out)['error']}")

        router.send_signal(signal.SIGTERM)
        if router.wait(timeout=60) != 0:
            raise RuntimeError(f"router: the router exited {router.returncode}")
        with open(rlog) as f:
            text = f.read()
        if "Traceback" in text:
            raise RuntimeError(f"router: the router logged an exception: {text[-3000:]}")
        launches = {p: stopped[p] - pods[p][2] for p in pods}
        want = {p: per_forward * forwards.get(p, 0) for p in pods}
        if launches != want:
            raise RuntimeError(f"router: flash launches on the router path {launches}, want "
                               f"{want} (one a layer for each forward the path sent)")
        stats["flash_launches_router"] = sum(launches.values())
        stats["router_path_s"] = time.monotonic() - t_path
        log(f"router: flash_attention launches on the router path: "
            f"{stats['flash_launches_router']}; wall: the router path took "
            f"{stats['router_path_s']:.1f} s")
        return stats
    finally:
        if router.poll() is None:
            router.kill()
            router.wait(timeout=60)


# -- phase 9: the model pool ----------------------------------------------------------

# the pool phase's streams: long enough to be mid-flight when the unload or
# the SIGTERM lands (one token per NDJSON line)
POOL_STREAM_PROMPT = 128
POOL_STREAM_TOKENS = 48
# the measured veto: admin loads of the checkpoint, one after another, until
# one is refused; at least this many models (the boot one included), and on
# the card as many as overfill its memory
POOL_VETO_LOADS = 6


def _http_full(port: int, method: str, path: str, body=None, timeout: float = 600.0):
    """(status, headers, JSON body) of one request."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    if method == "POST":
        POSTS[port] = POSTS.get(port, 0) + 1
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read() or b"{}")


def _pool_resources(base: str, nbytes: int, on_card: bool) -> None:
    """The disk tier needs the checkpoint's bytes once more beside it; the
    host tier (and on the card the pinned-buffer measurement) need them in
    RAM. Fails with the shortfall."""
    import shutil

    free = shutil.disk_usage(base).free
    need_disk = int(1.25 * nbytes * 1.02)
    mem = 0
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                mem = int(line.split()[1]) * 1024
    need_mem = int((2.0 if on_card else 1.25) * nbytes)
    log(f"pool: {base} has {free / 1e9:.1f} GB free (the disk tier needs {need_disk / 1e9:.1f} "
        f"GB); MemAvailable {mem / 1e9:.1f} GB (the host tier and the pinned buffer need "
        f"{need_mem / 1e9:.1f} GB)")
    if free < need_disk:
        raise RuntimeError(f"pool: {(need_disk - free) / 1e9:.1f} GB short of disk for the "
                           f"disk tier")
    if mem < need_mem:
        raise RuntimeError(f"pool: {(need_mem - mem) / 1e9:.1f} GB short of host RAM for the "
                           f"host tier")


def _wait_pool_state(sset, name: str, want: str, timeout: float = 600.0) -> dict:
    """The entry's snapshot once it reads ``want``; READY also waits for the
    load thread to add the server (a status read can see the server ready
    and report READY first, ROADMAP §C.5)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = sset.pool.states().get(name, {})
        if st.get("state") == want and (want != "READY" or name in sset.servers):
            return st
        if st.get("state") == "FAILED":
            raise RuntimeError(f"pool: {name} FAILED: {st.get('error')}")
        time.sleep(0.05)
    raise RuntimeError(f"pool: {name} did not reach {want} in {timeout} s: "
                       f"{sset.pool.states().get(name)}")


def _tier_event(pool, event: str, tier: str) -> dict:
    evs = [e for e in pool.flightrec.events() if e["event"] == event and e.get("tier") == tier]
    if not evs:
        raise RuntimeError(f"pool: no {event} {tier} event in the flight recorder")
    return evs[-1]


def _argmax(port: int, name: str, tokens) -> list:
    status, body = _http(port, f"/v1/{name}/forward", {"tokens": tokens.tolist()})
    if status != 200:
        raise RuntimeError(f"pool: /v1/{name}/forward answered {status} {body}")
    return body["logits_argmax"]


def _stream_lines(port: int, name: str, body: dict):
    """A streamed /v1/{name}/generate: (response, its first line)."""
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/{name}/generate",
                                 data=json.dumps({**body, "stream": True}).encode(),
                                 headers={"Content-Type": "application/json"})
    resp = urllib.request.urlopen(req, timeout=600)
    if resp.status != 200:
        raise RuntimeError(f"pool: a stream on {name} answered {resp.status}")
    return resp, resp.readline()


def _stream_tokens(raw: bytes) -> list:
    lines = [json.loads(x) for x in raw.splitlines() if x.strip()]
    if not lines or lines[-1] != {"done": True} or any("error" in x for x in lines):
        raise RuntimeError(f"pool: the stream did not end whole: {lines[-2:]}")
    return [t for x in lines[:-1] for t in x["tokens"][0]]


def phase_pool(cfg, ckpt: str, forwards: dict, device: str, root: str) -> dict:
    """The model pool (module docstring, phase 9): admin loads while
    serving, eviction under the budget into the host tier, promotion from
    host and from disk, the drain of one model and of the pod, and the
    measured veto. ``ckpt`` holds the checkpoint (every name loads it, so
    all share one tier content key); ``forwards`` maps each main-phase
    /v1/forward shape to (tokens, ``ckpt``'s argmax)."""
    import torch

    from modelx_tpu_torch.dl import serve_main
    from modelx_tpu_torch.ops import attention as attn

    on_card = device == "cuda"
    nbytes = os.path.getsize(os.path.join(ckpt, "model.safetensors"))
    _pool_resources(root, nbytes, on_card)
    stats: dict = {"pool_bytes": nbytes}
    attn.flash_attention.launches = 0  # the pool path's own count
    tokens, want = forwards[FORWARD_SHAPES[0]]
    want = want.tolist()
    port = _free_port()
    sset = httpd = None
    try:
        # (a) boot a
        t0 = time.monotonic()
        sset, httpd = serve_main.start([
            "--model", f"a={ckpt}", "--device", device, "--dtype", "bfloat16",
            "--max-seq-len", "2048", "--listen", f"127.0.0.1:{port}", "--allow-admin-load",
            "--evict-idle", "--hbm-budget-bytes", str(int(2.5 * nbytes)),
            "--host-state-budget-bytes", str(int(1.25 * nbytes)),
            "--disk-state-budget-bytes", str(int(1.25 * nbytes)),
            "--state-spool-dir", os.path.join(root, "spool"),
            "--staging-dir", os.path.join(root, "staging")])
        pool = sset.pool
        a = sset.servers["a"]
        stats["pool_boot_s"] = time.monotonic() - t0
        log(f"pool: (a) booted a in {stats['pool_boot_s']:.2f} s (load {a.stats['load_seconds']}"
            f" s at {a.stats['load_gbps']} GB/s); budget 2.5x, host and disk tiers 1.25x the "
            f"checkpoint's {nbytes} bytes")
        if _argmax(port, "a", tokens) != want:
            raise RuntimeError("pool: a's argmax differs from the source's")
        lone = []
        for _ in range(3):
            t0 = time.monotonic()
            _argmax(port, "a", tokens)
            lone.append((time.monotonic() - t0) * 1e3)
        stats["pool_forward_lone_ms"] = statistics.median(lone)

        # (b) load b while a serves
        status, _, body = _http_full(port, "POST", "/admin/models",
                                     {"name": "b", "model_dir": ckpt})
        t_post = time.monotonic()
        if status != 202 or body["b"]["state"] != "LOADING":
            raise RuntimeError(f"pool: (b) POST b answered {status} {body}")
        status, headers, body = _http_full(port, "POST", "/v1/b/forward",
                                           {"tokens": [[1, 2, 3]]})
        if status != 503 or "Retry-After" not in headers or "loading" not in body["error"]:
            raise RuntimeError(f"pool: (b) /v1/b/forward while loading: {status} {headers} {body}")
        status, headers, body = _http_full(port, "POST", "/v1/chat/completions", {
            "model": "b", "messages": [{"role": "user", "content": "hi"}], "max_tokens": 2})
        if (status != 503 or "Retry-After" not in headers
                or body.get("error", {}).get("type") != "server_error"):
            raise RuntimeError(f"pool: (b) chat on b while loading: {status} {headers} {body}")
        during = []
        while pool.states()["b"]["state"] == "LOADING" and len(during) < 50:
            t0 = time.monotonic()
            if _argmax(port, "a", tokens) != want:
                raise RuntimeError("pool: (b) a answered differently while b loaded")
            during.append((time.monotonic() - t0) * 1e3)
        _wait_pool_state(sset, "b", "READY")
        b = sset.servers["b"]
        stats.update(pool_cold_load_s=b.stats["load_seconds"],
                     pool_cold_load_gbps=b.stats["load_gbps"],
                     pool_cold_ready_s=b.stats["ready_seconds"],
                     pool_admin_ready_s=time.monotonic() - t_post,
                     pool_forward_during_load_ms=statistics.median(during) if during else None,
                     pool_forwards_during_load=len(during))
        if _argmax(port, "b", tokens) != want:
            raise RuntimeError("pool: (b) b's argmax differs from a's")
        during_ms = stats["pool_forward_during_load_ms"]
        log(f"pool: (b) POST b 202; while it loaded /v1/b/forward and chat answered 503 + "
            f"Retry-After, and a answered {len(during)} /v1/forward {list(tokens.shape)} at "
            f"median {during_ms if during_ms is None else round(during_ms, 1)} ms (alone "
            f"{stats['pool_forward_lone_ms']:.1f} ms); b READY {stats['pool_admin_ready_s']:.2f}"
            f" s after the POST (load {b.stats['load_seconds']} s at {b.stats['load_gbps']} "
            f"GB/s, ready {b.stats['ready_seconds']} s); b's argmax == a's")

        # (c) c evicts the least recently used idle model (a) into the host tier
        status, _, body = _http_full(port, "POST", "/admin/models",
                                     {"name": "c", "model_dir": ckpt, "wait": True})
        if status != 200 or body["c"]["state"] != "READY":
            raise RuntimeError(f"pool: (c) POST c answered {status} {body}")
        _, _, admin = _http_full(port, "GET", "/admin/models")
        if (admin["models"]["a"]["state"] != "UNLOADED" or admin["models"]["a"].get("tier") != "host"
                or admin["pool"]["evictions_total"] != 1):
            raise RuntimeError(f"pool: (c) eviction: {admin['models']} {admin['pool']}")
        demote = _tier_event(pool, "tier.demote", "host")
        stats.update(pool_demote_ms=demote["ms"],
                     pool_demote_gbps=demote["bytes"] / max(demote["ms"], 1e-3) / 1e6,
                     pool_c_load_s=sset.servers["c"].stats["load_seconds"],
                     pool_c_load_source=body["c"]["load_source"])
        log(f"pool: (c) POST c evicted a (UNLOADED, tier host, evictions_total 1): demoted "
            f"{demote['bytes'] / 1e9:.3f} GB to pinned host RAM in {demote['ms']} ms "
            f"({stats['pool_demote_gbps']:.2f} GB/s); c, the same content, then loaded from "
            f"the {body['c']['load_source']} in {stats['pool_c_load_s']} s")

        # (d) re-POST a: promoted from the host tier
        status, _, body = _http_full(port, "POST", "/admin/models",
                                     {"name": "a", "model_dir": ckpt, "wait": True})
        a = sset.servers.get("a")
        if (status != 200 or body["a"].get("load_source") != "tier" or a is None
                or a.stats.get("tier") != "host"):
            raise RuntimeError(f"pool: (d) re-POST a answered {status} {body}")
        if _argmax(port, "a", tokens) != want:
            raise RuntimeError("pool: (d) the promoted a answers a different argmax")
        stats.update(pool_promote_host_s=a.stats["load_seconds"],
                     pool_promote_host_gbps=a.stats["load_gbps"],
                     pool_promote_host_ready_s=a.stats["ready_seconds"])
        log(f"pool: (d) a promoted from host: {a.stats['load_bytes'] / 1e9:.3f} GB to the card "
            f"in {a.stats['load_seconds']} s ({a.stats['load_gbps']} GB/s; ready "
            f"{a.stats['ready_seconds']} s with the warm-up forward) against the cold admin "
            f"load's {stats['pool_cold_load_s']} s; argmax == before")

        # (e) spill the host tier to disk, re-POST the evicted model
        gone = next(n for n in ("b", "c") if pool.states()[n]["state"] == "UNLOADED")
        t0 = time.monotonic()
        if pool.tiers.spill_host() != 1:
            raise RuntimeError(f"pool: (e) spill_host moved nothing: {pool.tiers.snapshot()}")
        spool_s = time.monotonic() - t0
        status, _, body = _http_full(port, "POST", "/admin/models",
                                     {"name": gone, "model_dir": ckpt, "wait": True})
        g = sset.servers.get(gone)
        if status != 200 or g is None or g.stats.get("tier") != "disk":
            raise RuntimeError(f"pool: (e) re-POST {gone} answered {status} {body}")
        if _argmax(port, gone, tokens) != want:
            raise RuntimeError(f"pool: (e) {gone} promoted from disk answers a different argmax")
        unspool = _tier_event(pool, "tier.promote", "disk")
        stats.update(pool_spool_s=spool_s, pool_spool_gbps=nbytes / spool_s / 1e9,
                     pool_unspool_ms=unspool["ms"],
                     pool_unspool_gbps=unspool["bytes"] / max(unspool["ms"], 1e-3) / 1e6,
                     pool_promote_disk_s=g.stats["load_seconds"],
                     pool_promote_disk_gbps=g.stats["load_gbps"])
        log(f"pool: (e) spill_host spooled {nbytes / 1e9:.3f} GB in {spool_s:.2f} s "
            f"({stats['pool_spool_gbps']:.2f} GB/s); {gone} promoted from disk: unspool "
            f"{unspool['ms']} ms ({stats['pool_unspool_gbps']:.2f} GB/s), to the card "
            f"{g.stats['load_seconds']} s ({g.stats['load_gbps']} GB/s); argmax == before")
        if on_card:
            stats.update(_host_buffers(g.params))

        # (f) DELETE a model with a stream in flight on it
        serving = [n for n in ("a", "b", "c") if pool.states()[n]["state"] == "READY"]
        target, last = serving[-1], serving[0]
        gen = torch.Generator().manual_seed(5)
        gen_body = {"tokens": torch.randint(0, cfg.vocab_size, (1, POOL_STREAM_PROMPT),
                                            generator=gen).tolist(),
                    "max_new_tokens": POOL_STREAM_TOKENS}
        status, whole = _http(port, f"/v1/{target}/generate", gen_body)
        if status != 200:
            raise RuntimeError(f"pool: (f) generate on {target} answered {status} {whole}")
        resp, first = _stream_lines(port, target, gen_body)
        status, _, body = _http_full(port, "DELETE", f"/admin/models/{target}?wait=0")
        if status != 202 or body[target]["state"] != "DRAINING":
            raise RuntimeError(f"pool: (f) DELETE {target} answered {status} {body}")
        status, _, body = _http_full(port, "POST", f"/v1/{target}/forward", {"tokens": [[1, 2]]})
        if status != 409 or "draining" not in body["error"]:
            raise RuntimeError(f"pool: (f) a request during the drain answered {status} {body}")
        streamed = _stream_tokens(first + resp.read())
        if streamed != whole["tokens"][0][POOL_STREAM_PROMPT:]:
            raise RuntimeError("pool: (f) the drained stream differs from the whole answer")
        st = _wait_pool_state(sset, target, "UNLOADED")
        status, _, body = _http_full(port, "DELETE", f"/admin/models/{last}")
        if status != 409 or "last serving model" not in body["error"]:
            raise RuntimeError(f"pool: (f) DELETE of the last model answered {status} {body}")
        stats["pool_drain_s"] = st["drain_seconds"]
        stats["pool_tiers"] = pool.tiers.snapshot()
        log(f"pool: (f) DELETE {target} mid-stream: 202, new requests 409, the stream ended "
            f"whole ({len(streamed)} tokens == the non-streamed answer), drain_seconds "
            f"{st['drain_seconds']}; DELETE of the last model ({last}) refused 409; tiers "
            f"{stats['pool_tiers']}")

        # (g) a serve_main child drains its in-flight stream on SIGTERM
        stats.update(_pod_drain(ckpt, device, gen_body, root))

        # (h) the measured veto, on a pool with no budget
        httpd.shutdown()
        httpd.server_close()
        httpd = None
        _free(*sset.servers.values())
        pool.tiers.close()
        sset = None
        stats.update(_pool_veto(ckpt, device, root, tokens, want, nbytes))
        stats["flash_launches_pool"] = attn.flash_attention.launches
        if on_card and not stats["flash_launches_pool"]:
            raise RuntimeError("pool: the pool path launched no flash kernel")
        return stats
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if sset is not None:
            _free(*sset.servers.values())
            sset.pool.tiers.close()


def _host_buffers(params: dict) -> dict:
    """Pinned against pageable host buffers for one model's tensors, in one
    call: the pinned allocation (served from torch's pinned-memory cache
    when the host tier's buffer was freed before), then device->host and
    host->device copies through it, against the same copies through
    pageable tensors. Host->device moves half the bytes: the card holds two
    models beside the copies."""
    import torch

    tensors = [t for t in params.values() if isinstance(t, torch.Tensor)]
    total = sum(t.nbytes for t in tensors)
    half = tensors[:len(tensors) // 2]
    half_bytes = sum(t.nbytes for t in half)
    out = {}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    pinned = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    out["pin_alloc_s"] = time.monotonic() - t0
    views, off = [], 0
    for t in tensors:
        views.append(pinned[off:off + t.nbytes].view(t.dtype).view(t.shape))
        off += t.nbytes
    t0 = time.monotonic()
    for v, t in zip(views, tensors):
        v.copy_(t, non_blocking=True)
    torch.cuda.synchronize()
    out["pinned_d2h_gbps"] = total / (time.monotonic() - t0) / 1e9
    back = [torch.empty_like(t) for t in half]
    t0 = time.monotonic()
    for d, v in zip(back, views):
        d.copy_(v, non_blocking=True)
    torch.cuda.synchronize()
    out["pinned_h2d_gbps"] = half_bytes / (time.monotonic() - t0) / 1e9
    del back, views, pinned
    t0 = time.monotonic()
    host = [t.to("cpu") for t in tensors]
    out["pageable_d2h_gbps"] = total / (time.monotonic() - t0) / 1e9
    t0 = time.monotonic()
    back = [h.to("cuda") for h in host[:len(half)]]
    torch.cuda.synchronize()
    out["pageable_h2d_gbps"] = half_bytes / (time.monotonic() - t0) / 1e9
    del back, host
    torch.cuda.empty_cache()
    log(f"pool: host buffers for {total / 1e9:.3f} GB: the pin_memory allocation took "
        f"{out['pin_alloc_s']:.2f} s; pinned d2h {out['pinned_d2h_gbps']:.2f} GB/s, h2d "
        f"{out['pinned_h2d_gbps']:.2f} GB/s; pageable d2h {out['pageable_d2h_gbps']:.2f} GB/s, "
        f"h2d {out['pageable_h2d_gbps']:.2f} GB/s")
    return out


def _pod_drain(ckpt: str, device: str, gen_body: dict, root: str) -> dict:
    """serve_main in a child process with --drain-grace 30: SIGTERM while a
    stream is in flight."""
    import signal

    port = _free_port()
    log_path = os.path.join(root, "pod-drain.log")
    log_f = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "modelx_tpu_torch.dl.serve_main", "--model", f"m={ckpt}",
         "--device", device, "--dtype", "bfloat16", "--listen", f"127.0.0.1:{port}",
         "--drain-grace", "30"],
        cwd=REPO, env=_child_env(), stdout=log_f, stderr=subprocess.STDOUT)
    log_f.close()
    try:
        deadline = time.monotonic() + 300
        while True:
            if proc.poll() is not None:
                raise RuntimeError(f"pool: (g) serve_main exited {proc.returncode}: "
                                   f"{open(log_path).read()[-3000:]}")
            try:
                if _http_raw(port, "/healthz")[0] == 200:
                    break
            except OSError:
                pass
            if time.monotonic() > deadline:
                raise RuntimeError("pool: (g) serve_main did not answer /healthz in 300 s")
            time.sleep(0.2)
        status, whole = _http(port, "/v1/m/generate", gen_body)
        if status != 200:
            raise RuntimeError(f"pool: (g) generate answered {status} {whole}")
        resp, first = _stream_lines(port, "m", gen_body)
        t0 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        status = headers = body = None
        while time.monotonic() - t0 < 30:
            status, headers, body = _http_full(port, "GET", "/healthz", timeout=10)
            if status == 503:
                break
            time.sleep(0.02)
        if status != 503 or body.get("status") != "draining" or "Retry-After" in headers:
            raise RuntimeError(f"pool: (g) /healthz after SIGTERM: {status} {headers} {body}")
        live = _http_raw(port, "/livez")
        if live[0] != 200:
            raise RuntimeError(f"pool: (g) /livez while draining answered {live}")
        streamed = _stream_tokens(first + resp.read())
        if streamed != whole["tokens"][0][POOL_STREAM_PROMPT:]:
            raise RuntimeError("pool: (g) the stream across SIGTERM differs from the whole answer")
        rc = proc.wait(timeout=120)
        drain_s = time.monotonic() - t0
        if rc != 0:
            raise RuntimeError(f"pool: (g) serve_main exited {rc} after SIGTERM: "
                               f"{open(log_path).read()[-3000:]}")
        log(f"pool: (g) SIGTERM mid-stream: /healthz 503 draining (no Retry-After), /livez 200, "
            f"the stream completed whole ({len(streamed)} tokens), exit 0 {drain_s:.2f} s "
            f"after the signal")
        return {"pod_drain_s": drain_s}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)


def _pool_veto(ckpt: str, device: str, root: str, tokens, want: list, nbytes: int) -> dict:
    """Admin loads of the checkpoint on a pool with no budget until one is
    refused: devmem's measured veto (507) or a real out-of-memory error on
    the card (the shed-and-retry path). No load may end FAILED while an
    idle model could have been shed."""
    from modelx_tpu_torch.dl import serve_main
    from modelx_tpu_torch.utils import devmem

    on_card = device == "cuda"
    port = _free_port()
    sset, httpd = serve_main.start([
        "--model", f"v0={ckpt}", "--device", device, "--dtype", "bfloat16",
        "--listen", f"127.0.0.1:{port}", "--allow-admin-load",
        "--staging-dir", os.path.join(root, "staging-veto")])
    pool = sset.pool
    rows = []
    outcome = "none"
    # on the card, loads enough to fill it whatever the checkpoint's size
    loads = POOL_VETO_LOADS
    if on_card:
        import torch

        loads = max(loads, torch.cuda.get_device_properties(0).total_memory // nbytes + 2)
    try:
        for i in range(1, loads):
            dm = devmem.sample(max_age_s=0)
            reserved = pool.reserved_bytes()
            status, _, body = _http_full(port, "POST", "/admin/models",
                                         {"name": f"v{i}", "model_dir": ckpt, "wait": True})
            cache = sum(d["reserved_bytes"] - d["allocated_bytes"]
                        for d in dm.get("devices", {}).values())
            rows.append({"load": i, "status": status, "reserved_before": reserved,
                         "measured_in_use_before": dm["hbm_bytes_in_use"],
                         "measured_reservable_before": dm["hbm_bytes_reservable"],
                         "allocator_cache_before": cache, "source": dm["source"]})
            state = body.get(f"v{i}", {}).get("state")
            log(f"pool: (h) load v{i}: {status} {body.get('error') or state}; before it the pool "
                f"reserved {reserved / 1e9:.3f} GB, devmem measured {dm['hbm_bytes_in_use'] / 1e9:.3f}"
                f" GB in use and {dm['hbm_bytes_reservable'] / 1e9:.3f} GB reservable (allocator "
                f"cache {cache / 1e9:.3f} GB; source {dm['source']})")
            if status == 507:
                if "device measures only" not in body["error"]:
                    raise RuntimeError(f"pool: (h) a 507 that is not the measured veto: {body}")
                outcome = "measured_veto_507"
                break
            if state == "FAILED":
                idle = [n for n, s in pool.states().items() if s["state"] == "READY"]
                raise RuntimeError(f"pool: (h) load v{i} FAILED ({body}) with idle models "
                                   f"{idle} that could have been shed")
            if status != 200 or state != "READY":
                raise RuntimeError(f"pool: (h) load v{i} answered {status} {body}")
            if any(e["event"] == "pool.oom_retry" for e in pool.flightrec.events()):
                outcome = "oom_shed_and_retry"
                break
        loaded = [n for n, s in pool.states().items() if s["state"] == "READY"]
        if _argmax(port, loaded[-1], tokens) != want:
            raise RuntimeError(f"pool: (h) {loaded[-1]} answers a different argmax")
        if on_card and outcome == "none":
            raise RuntimeError(f"pool: (h) {loads} loads of {nbytes / 1e9:.1f} GB "
                               f"were all admitted")
        log(f"pool: (h) outcome {outcome}, {len(loaded)} models loaded")
        return {"pool_veto_outcome": outcome, "pool_veto_loaded": len(loaded),
                "pool_veto_rows": rows}
    finally:
        httpd.shutdown()
        httpd.server_close()
        _free(*sset.servers.values())


# -- phase 13: the static analysis and runtime lockdep on the card -------------------------

LOCKDEP_CLIENTS = 8
LOCKDEP_PROMPT = 96
LOCKDEP_NEW_TOKENS = 16
LOCKDEP_FORWARD = (1, 2048)  # /v1/forward: the flash kernel's prefill shape
LOCKDEP_DRAIN_TOKENS = 64  # the stream in flight while the pod drains
LOCKDEP_HOLD_MS = 200.0  # the reference's default hold threshold
LOCKDEP_TOP_FRAMES = 3


def lint_gate() -> dict:
    """The port's lint over the checkout (``python -m
    modelx_tpu_torch.analysis``): fails on a new finding or an unused
    baseline entry."""
    import subprocess

    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", "modelx_tpu_torch.analysis", "--root", REPO],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    secs = time.monotonic() - t0
    summary = (proc.stdout.strip().splitlines() or [""])[-1]
    if proc.returncode != 0 or "unused baseline suppression" in proc.stderr:
        raise RuntimeError(f"lockdep: the lint gate failed (rc {proc.returncode}):\n"
                           f"{proc.stdout[-3000:]}{proc.stderr[-2000:]}")
    log(f"lockdep: lint gate clean in {secs:.2f} s: {summary}")
    return {"lint_s": secs, "lint_summary": summary}


def _site(site: str) -> str:
    """A lock class (allocation site) relative to the checkout."""
    return site[len(REPO) + 1:] if site.startswith(REPO + os.sep) else site


def _frames(stack, n: int = LOCKDEP_TOP_FRAMES) -> str:
    return " < ".join(f"{_site(fn)}:{ln} {name}" for fn, ln, name in reversed(stack[-n:]))


def lockdep_report(graph) -> dict:
    """Print the graph's lock classes, edges and over-threshold holds (top
    frames and ms, the longest first); fail on a cycle."""
    classes = sorted(_site(c) for c in graph.classes)
    edges = {_site(a): sorted(_site(b) for b in bs) for a, bs in sorted(graph.edges().items())}
    import linecache

    holds = graph.long_holds
    counts = graph.hold_counts()
    log(f"lockdep: {len(classes)} lock classes, {sum(map(len, edges.values()))} order edges, "
        f"{graph.acquisitions} acquisitions, {len(graph.cycles)} cycles, "
        f"{len(holds)} classes with holds over {graph.hold_threshold_s * 1e3:.0f} ms")
    for c in classes:
        path, _, line = c.rpartition(":")
        src = linecache.getline(path if os.path.isabs(path) else os.path.join(REPO, path),
                                int(line) if line.isdigit() else 0).strip()
        log(f"lockdep:   class {c}  {src}")
    for a, bs in edges.items():
        log(f"lockdep:   edge {a} -> {', '.join(bs)}")
    for h in holds:
        log(f"lockdep:   hold {_site(h.site)}: {h.duration_s * 1e3:.1f} ms (worst of "
            f"{counts.get(h.site, 1)}) in {h.thread_name!r}; acquired at {_frames(h.acquire_stack)};"
            f" released at {_frames(h.release_stack)}")
    longest = holds[0] if holds else None
    if longest is not None:
        log(f"lockdep: longest hold {_site(longest.site)} {longest.duration_s * 1e3:.1f} ms")
    if graph.cycles:
        raise RuntimeError("lockdep: lock-order cycle(s) on the card:\n"
                           + "\n\n".join(c.render() for c in graph.cycles))
    return {"lockdep_classes": len(classes), "lockdep_edges": sum(map(len, edges.values())),
            "lockdep_acquisitions": graph.acquisitions, "lockdep_cycles": 0,
            "lockdep_long_holds": [{"site": _site(h.site), "ms": h.duration_s * 1e3,
                                    "count": counts.get(h.site, 1), "thread": h.thread_name,
                                    "acquired_at": _frames(h.acquire_stack)} for h in holds],
            "lockdep_longest_hold_ms": longest.duration_s * 1e3 if longest else 0.0,
            "lockdep_longest_hold_site": _site(longest.site) if longest else None}


def phase_lockdep(cfg, ckpt: str, device: str, forwards: dict | None = None) -> dict:
    """Phase 13 (module docstring): the lint gate, then a continuous-batch
    pod built under the port's lockdep on ``ckpt`` and driven by concurrent
    clients, an admin load and unload and a drain; no lock-order cycle.
    ``forwards`` maps a /v1/forward shape to (tokens, argmax) served from
    the same weights (the later checkpoint's), checked when it holds
    ``LOCKDEP_FORWARD``. The kernel count is this phase's own, from 0."""
    import threading

    import torch

    from modelx_tpu_torch.analysis import lockdep
    from modelx_tpu_torch.dl import serve_main
    from modelx_tpu_torch.ops import attention as attn

    on_card = device == "cuda"
    t_phase = time.monotonic()
    stats = lint_gate()
    # only locks made after the install are instrumented: the pod comes after
    ours = lockdep._saved is None
    graph = lockdep.install(lockdep.LockGraph(hold_threshold_ms=LOCKDEP_HOLD_MS))
    attn.flash_attention.launches = 0
    port = _free_port()
    sset = httpd = None
    try:
        t0 = time.monotonic()
        sset, httpd = serve_main.start([
            "--model", f"a={ckpt}", "--listen", f"127.0.0.1:{port}", "--device", device,
            "--dtype", "bfloat16", "--max-seq-len", str(max(LOCKDEP_FORWARD[1], 1024)),
            "--continuous-batch", "--max-slots", str(LOCKDEP_CLIENTS), "--prefix-cache", "4",
            "--allow-admin-load"])
        stats["lockdep_boot_s"] = time.monotonic() - t0
        boot_launches = attn.flash_attention.launches
        rng = torch.Generator().manual_seed(13)

        # /v1/forward at the prefill shape: the flash kernel, once per layer
        tokens = (forwards[LOCKDEP_FORWARD][0] if forwards and LOCKDEP_FORWARD in forwards
                  else torch.randint(0, cfg.vocab_size, LOCKDEP_FORWARD, generator=rng))
        before = attn.flash_attention.launches
        t0 = time.monotonic()
        got = _argmax(port, "a", tokens)
        stats["lockdep_forward_ms"] = (time.monotonic() - t0) * 1e3
        fwd_launches = attn.flash_attention.launches - before
        if on_card and fwd_launches != cfg.num_layers:
            raise RuntimeError(f"lockdep: /v1/forward launched flash_attention {fwd_launches} "
                               f"times, want {cfg.num_layers}")
        if forwards and LOCKDEP_FORWARD in forwards:
            if got != forwards[LOCKDEP_FORWARD][1].tolist():
                raise RuntimeError("lockdep: /v1/forward answered another argmax than the "
                                   "same weights served before the phase")
        elif got != _argmax(port, "a", tokens):
            raise RuntimeError("lockdep: a repeated /v1/forward answered differently")

        # 8 concurrent clients: each a streamed and a whole greedy /v1/generate
        prompts = [torch.randint(0, cfg.vocab_size, (LOCKDEP_PROMPT,), generator=rng).tolist()
                   for _ in range(LOCKDEP_CLIENTS)]
        results: dict = {}
        errors: list = []

        def client(i: int) -> None:
            try:
                body = {"tokens": [prompts[i]], "max_new_tokens": LOCKDEP_NEW_TOKENS}
                streamed, _, _ = _stream(port, body)
                status, whole = _http(port, "/v1/a/generate", body)
                if status != 200:
                    raise RuntimeError(f"whole generate answered {status} {whole}")
                results[i] = (streamed, whole["tokens"][0][LOCKDEP_PROMPT:])
            except Exception as e:  # reported below, with the client's index
                errors.append((i, repr(e)))

        t0 = time.monotonic()
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(LOCKDEP_CLIENTS)]
        for t in threads:
            t.start()

        # meanwhile: an admin load and unload of a second name
        st, _, body = _http_full(port, "POST", "/admin/models",
                                 {"name": "b", "model_dir": ckpt, "wait": True})
        if st != 200 or body.get("b", {}).get("state") != "READY":
            raise RuntimeError(f"lockdep: the admin load of b answered {st} {body}")
        if _argmax(port, "b", tokens) != got:
            raise RuntimeError("lockdep: b (the same checkpoint) answered another argmax")
        st, _, body = _http_full(port, "DELETE", "/admin/models/b")
        if st != 200:
            raise RuntimeError(f"lockdep: the unload of b answered {st} {body}")
        stats["lockdep_admin_s"] = time.monotonic() - t0
        for t in threads:
            t.join(timeout=600)
        if errors or len(results) != LOCKDEP_CLIENTS:
            raise RuntimeError(f"lockdep: clients failed: {errors[:3]}")
        for i, (streamed, whole) in results.items():
            if streamed != whole or len(whole) != LOCKDEP_NEW_TOKENS:
                raise RuntimeError(f"lockdep: client {i}: the stream {streamed} != whole {whole}")
        stats["lockdep_clients_s"] = time.monotonic() - t0

        # a drain with a stream in flight: /healthz 503, the stream ends whole
        resp, first = _stream_lines(port, "a", {"tokens": [prompts[0]],
                                                "max_new_tokens": LOCKDEP_DRAIN_TOKENS})
        t0 = time.monotonic()
        drained = threading.Thread(target=serve_main.drain,
                                   args=(sset, 0.0, 60.0, threading.Event()), daemon=True)
        drained.start()
        st, body = _http(port, "/healthz")
        raw = first + resp.read()
        resp.close()
        drained.join(timeout=120)
        if st != 503 or drained.is_alive() or sset.inflight:
            raise RuntimeError(f"lockdep: the drain: /healthz {st} {body}, "
                               f"in flight {sset.inflight}")
        if len(_stream_tokens(raw)) != LOCKDEP_DRAIN_TOKENS:
            raise RuntimeError("lockdep: the stream in flight at the drain did not end whole")
        stats["lockdep_drain_s"] = time.monotonic() - t0
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if sset is not None:
            sset.close()
            _free(*sset.servers.values())
        if ours:
            lockdep.uninstall()
    stats["flash_launches_lockdep"] = attn.flash_attention.launches
    if on_card and stats["flash_launches_lockdep"] < 1:
        raise RuntimeError("lockdep: the phase launched the flash kernel no time")
    log(f"lockdep: pod up in {stats['lockdep_boot_s']:.2f} s; /v1/forward "
        f"{list(LOCKDEP_FORWARD)} {stats['lockdep_forward_ms']:.1f} ms; {LOCKDEP_CLIENTS} "
        f"clients (stream == whole) in {stats['lockdep_clients_s']:.2f} s, b's admin load and "
        f"unload meanwhile in {stats['lockdep_admin_s']:.2f} s; drain "
        f"{stats['lockdep_drain_s']:.2f} s; flash "
        f"launches {stats['flash_launches_lockdep']} (boot warm-up {boot_launches}, forward "
        f"{fwd_launches}, b's load warm-up and forward the rest)")
    stats.update(lockdep_report(graph))
    stats["lockdep_phase_s"] = time.monotonic() - t_phase
    log(f"lockdep: the phase took {stats['lockdep_phase_s']:.1f} s")
    return stats


def lockdep_alone(device: str = "cuda", cfg=None) -> dict:
    """Phase 13 alone (``--phases lockdep``): the later phases' checkpoint
    (Llama-3-8B's widths at ``LATER_LAYERS``, seed 0) written here, then
    the phase on it."""
    import dataclasses
    import shutil

    import torch

    from modelx_tpu_torch.dl import safetensors as st
    from modelx_tpu_torch.models import llama

    cfg = cfg or llama.LlamaConfig.llama3_8b()
    cut = dataclasses.replace(cfg, num_layers=min(cfg.num_layers, LATER_LAYERS))
    nbytes = 2 * sum(math.prod(s) for s in llama.param_shapes(cut).values())
    ckpt = _checkpoint_dir(nbytes)
    try:
        t0 = time.monotonic()
        gen = torch.Generator(device=device).manual_seed(0)
        params = llama.init_params(cut, gen, dtype=torch.bfloat16)
        st.write_safetensors(os.path.join(ckpt, "model.safetensors"), params)
        del params
        log(f"lockdep: wrote the later phases' checkpoint ({cut.num_layers} layers, "
            f"{nbytes / 1e9:.3f} GB) in {time.monotonic() - t0:.1f} s")
        return phase_lockdep(cut, ckpt, device)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


# -- phase 10: the continuous engine ----------------------------------------------------

# the mixed traffic: one client per prompt length, half greedy, half seeded
# sampled (odd clients), CONT_NEW_TOKENS each; CONT_LATE joins mid-decode,
# once client 0 has streamed CONT_LATE_AFTER tokens
CONT_PROMPTS = (128, 512, 1000, 128, 512, 1000, 128, 512)
# 64 until the objectstore path joined the smoke's time limit; the
# engine's speculation keeps SPEC_NEW_TOKENS
CONT_NEW_TOKENS = 32
CONT_LATE, CONT_LATE_AFTER = 7, 8
CONT_SLOTS, CONT_MAX_LEN, CONT_CHUNK = 8, 2048, 8
# the in-process paged engines: 32 slots over a 32,768-token pool of 16-token pages
PAGED_SLOTS, PAGE_SIZE, KV_LIVE_TOKENS = 32, 16, 32768
# chunked prefill: a FILL_CLIENT fill lands in PREFILL_CHUNK pieces while
# the FILL_DECODE_CLIENTS decode
PREFILL_CHUNK = 256
FILL_CLIENT, FILL_DECODE_CLIENTS = 2, (0, 6)
RESUME_CLIENT, RESUME_AFTER = 1, 10
QUEUE_DEPTH, QUEUE_BURST = 2, 12
# the engine's speculation on spec_prompt: the share of proposals it must
# accept where its tokens leave the plain decoder's (which accepted 0.775
# of them in the options phase; a random prompt gives next to none)
CONT_SPEC_MIN_RATE = 0.5
# the serve_main child prints its kernel count when SIGTERM ends it
SERVE_CHILD = r"""
import signal, sys
from modelx_tpu_torch.dl import serve_main
from modelx_tpu_torch.ops import attention as attn
# the count so far, on demand: a path that shares the pod reads it apart
signal.signal(signal.SIGUSR1, lambda *_: print("FLASH_LAUNCHES_NOW",
                                               attn.flash_attention.launches, flush=True))
rc = serve_main.main(sys.argv[1:])
print("FLASH_LAUNCHES", attn.flash_attention.launches, flush=True)
sys.exit(rc)
"""


def _cont_requests(cfg) -> list:
    import torch

    rng = torch.Generator().manual_seed(9)
    reqs = []
    for i, plen in enumerate(CONT_PROMPTS):
        prompt = torch.randint(0, cfg.vocab_size, (plen,), generator=rng).tolist()
        # temperature only: a top_k / top_p cut moves with the logits'
        # last bits, so a bf16 near-tie at its edge is not a near-tie of the
        # draw (the filters' parity is the CPU tests' and the main phase's)
        samp = {} if i % 2 == 0 else {"temperature": 0.8, "seed": 100 + i}
        reqs.append((prompt, samp))
    return reqs


def _post(port: int, path: str, body: dict, headers: dict | None = None,
          timeout: float = 600.0):
    """(status, headers, raw body) of one POST."""
    import urllib.error
    import urllib.request

    POSTS[port] = POSTS.get(port, 0) + 1
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _stream_timed(port: int, body: dict, on_token=None, stop_after: int = 0):
    """A streamed /v1/generate: (tokens, each token's seconds since the
    request). ``stop_after`` > 0 closes the connection after that many
    tokens (a client that goes away)."""
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/generate",
                                 data=json.dumps({**body, "stream": True}).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    toks, times, done = [], [], False
    with urllib.request.urlopen(req, timeout=600) as r:
        for raw in r:
            line = json.loads(raw)
            if "error" in line:
                raise RuntimeError(f"continuous: a stream ended with {line}")
            if line == {"done": True}:
                done = True
                break
            toks.extend(line["tokens"][0])
            times.append(time.monotonic() - t0)
            if on_token is not None:
                on_token(len(toks))
            if stop_after and len(toks) >= stop_after:
                return toks, times
    if not done:
        raise RuntimeError("continuous: a stream ended without its done line")
    return toks, times


def _pcts(xs: list) -> tuple[float, float]:
    import numpy as np

    a = np.asarray(xs, np.float64)
    return float(np.percentile(a, 50)), float(np.percentile(a, 99))


def _serve_child(ckpt: str, device: str, port: int, root: str, name: str = MODEL,
                 slots: int | None = None, what: str = "continuous", extra: tuple = (),
                 env: dict | None = None):
    """A ``serve_main --continuous-batch --prefix-cache 4`` child serving
    ``ckpt`` as ``name`` with ``slots`` slots (``CONT_SLOTS``), ``extra``
    flags and ``env`` over the children's environment; (the process, its
    log's path) once it answers /healthz. ``what`` prefixes its errors."""
    log_path = os.path.join(root, f"serve-{re.sub(r'[^A-Za-z0-9]+', '-', what)}-{name}.log")
    log_f = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", SERVE_CHILD, "--model", f"{name}={ckpt}", "--device", device,
         "--dtype", "bfloat16", "--max-seq-len", str(CONT_MAX_LEN), "--listen",
         f"127.0.0.1:{port}", "--continuous-batch", "--max-slots", str(slots or CONT_SLOTS),
         "--prefix-cache", "4", "--stream-chunk-size", str(CONT_CHUNK), "--drain-grace", "30",
         *extra],
        cwd=REPO, env={**_child_env(), **(env or {})}, stdout=log_f, stderr=subprocess.STDOUT)
    log_f.close()
    deadline = time.monotonic() + 300
    while True:
        if proc.poll() is not None:
            raise RuntimeError(f"{what}: serve_main exited {proc.returncode}: "
                               f"{open(log_path).read()[-3000:]}")
        try:
            if _http_raw(port, "/healthz")[0] == 200:
                return proc, log_path
        except OSError:
            pass
        if time.monotonic() > deadline:
            proc.kill()
            raise RuntimeError(f"{what}: serve_main did not answer /healthz in 300 s")
        time.sleep(0.2)


def _stop_serve_child(proc, log_path: str, what: str) -> int:
    """SIGTERM a ``_serve_child``, wait for its drain and exit 0; the flash
    launches it printed on the way out."""
    import signal

    proc.send_signal(signal.SIGTERM)
    if proc.wait(timeout=120) != 0:
        raise RuntimeError(f"{what}: serve_main exited {proc.returncode}: "
                           f"{open(log_path).read()[-3000:]}")
    counts = re.findall(r"^FLASH_LAUNCHES (\d+)$", open(log_path).read(), re.M)
    return int(counts[-1]) if counts else -1


def _engine(server, **kw):
    from modelx_tpu_torch.dl.continuous import ContinuousBatcher

    return ContinuousBatcher(server, chunk_size=CONT_CHUNK, max_len=CONT_MAX_LEN, **kw)


def _engine_burst(cb, reqs: list, n_new: int | None = None) -> tuple[list, float]:
    """Submit every request as one burst, in order, each for ``n_new``
    tokens (``CONT_NEW_TOKENS``); (new tokens per request, wall seconds)."""
    import numpy as np

    t0 = time.monotonic()
    tickets = cb.submit_many([(p, n_new or CONT_NEW_TOKENS, s) for p, s in reqs])
    outs = [np.concatenate(list(cb._drain_row(t.out)), axis=1)[0].tolist() for t in tickets]
    return outs, time.monotonic() - t0


def _release(cb) -> None:
    import gc

    import torch

    cb.close()
    cb.release_device_state()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _step_cost(cb, rows: int, length: int, on_card: bool, reps: int = 5) -> dict:
    """One chunk step [slots, 1] of an idle engine, with ``rows`` greedy
    rows at ``length`` positions (each its own pages when paged): device
    operations (a profiler trace) and ms a step (CUDA events). The engine
    thread waits on its empty queue meanwhile; the host state is put back."""
    import torch

    saved = (cb._offsets.copy(), cb._temp.copy())
    table = cb._table.copy() if cb.page_size else None
    try:
        cb._offsets[:] = 0
        cb._offsets[:rows] = length
        cb._temp[:] = 0.0
        if cb.page_size:
            per = -(-(length + 1) // cb.page_size)
            cb._table[:] = 0
            for r in range(rows):
                cb._table[r, :per] = 1 + r * per + torch.arange(per).numpy()
        with cb.server._device_lock, torch.inference_mode():
            cb._chunk(1)  # warm
            if not on_card:
                return {"ops": None, "ms": None}
            ops = _device_events(lambda: cb._chunk(1))
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(reps):
                cb._chunk(1)
            end.record()
            torch.cuda.synchronize()
            return {"ops": ops, "ms": start.elapsed_time(end) / reps}
    finally:
        cb._offsets[:], cb._temp[:] = saved
        if table is not None:
            cb._table[:] = table


def phase_continuous(cfg, ckpt: str, device: str, root: str) -> dict:
    """The continuous engine (module docstring, phase 10), on ``ckpt``
    (``root`` takes its child's log): the plain reference and the window batcher in-process, a
    ``--continuous-batch`` serve_main child over HTTP (mixed traffic,
    resume, 504, a forward while rows decode), the 429 of a bounded
    backlog, then in-process engines one at a time: dense and paged gather
    at 32 slots (byte-equal), in place, chunked prefill with and without,
    speculation. Its flash launches are counted from 0: the warm-ups and
    the forwards, none in admission or decode."""
    import concurrent.futures
    import threading
    import warnings

    import numpy as np
    import torch

    from modelx_tpu_torch.dl.serve import Batcher, ModelServer, ServerSet, serve
    from modelx_tpu_torch.ops import attention as attn

    on_card = device == "cuda"
    per_forward = cfg.num_layers if on_card else 0
    stats: dict = {}
    attn.flash_attention.launches = 0  # the continuous path's own count
    server = ModelServer(ckpt, dtype="bfloat16", device=device, max_seq_len=CONT_MAX_LEN,
                         name=MODEL)
    server.load()
    warm = attn.flash_attention.launches
    reqs = _cont_requests(cfg)
    n_new = CONT_NEW_TOKENS
    proc = httpd = None
    engines = []

    def no_flash(what, fn):
        before = attn.flash_attention.launches
        out = fn()
        if attn.flash_attention.launches != before:
            raise RuntimeError(f"continuous: {what} launched the flash kernel "
                               f"{attn.flash_attention.launches - before} times")
        return out

    try:
        # the plain reference, one request at a time (no engine)
        want, plain_s = [], []
        for prompt, samp in reqs:
            t0 = time.monotonic()
            out = no_flash("the plain decode", lambda: server.generate(
                np.asarray([prompt], np.int32), max_new_tokens=n_new, **samp))
            plain_s.append(time.monotonic() - t0)
            want.append(out[0, len(prompt):].tolist())
        total = n_new * len(reqs)
        stats["cont_plain_tps"] = total / sum(plain_s)
        log(f"continuous: the plain path one request at a time: {total} tokens in "
            f"{sum(plain_s):.2f} s, {stats['cont_plain_tps']:.1f} tokens/s")
        # the window batcher, all at once
        batcher = Batcher(server, max_batch=len(reqs), window_ms=200.0)
        try:
            t0 = time.monotonic()
            with concurrent.futures.ThreadPoolExecutor(len(reqs)) as ex:
                got = list(ex.map(lambda r: no_flash("the batcher", lambda: batcher.generate(
                    np.asarray([r[0]], np.int32), max_new_tokens=n_new, **r[1])), reqs))
            stats["cont_batcher_tps"] = total / (time.monotonic() - t0)
            if any(g.shape != (1, len(r[0]) + n_new) for g, r in zip(got, reqs)):
                raise RuntimeError("continuous: the batcher answered a bad shape")
            log(f"continuous: --dynamic-batch's batcher, all at once: "
                f"{stats['cont_batcher_tps']:.1f} tokens/s ({batcher.batches} device calls)")
        finally:
            batcher.close()

        # the serve_main child: mixed concurrent traffic over HTTP
        port = _free_port()
        t0 = time.monotonic()
        proc, child_log = _serve_child(ckpt, device, port, root)
        log(f"continuous: serve_main --continuous-batch --max-slots {CONT_SLOTS} --prefix-cache 4 "
            f"up in {time.monotonic() - t0:.1f} s")
        late_go = threading.Event()
        results = [None] * len(reqs)
        errors = []

        def client(i):
            try:
                if i == CONT_LATE:
                    late_go.wait(600)
                prompt, samp = reqs[i]
                t0 = time.monotonic()
                on_token = ((lambda n: n >= CONT_LATE_AFTER and late_go.set()) if i == 0
                            else None)
                toks, times = _stream_timed(port, {"tokens": [prompt], "max_new_tokens": n_new,
                                                   **samp}, on_token=on_token)
                results[i] = (toks, times, t0, time.monotonic())
            except Exception as e:  # reported below, after every thread ends
                errors.append(f"client {i}: {e!r}")
                late_go.set()

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(len(reqs))]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.monotonic() - t0
        if errors or any(r is None for r in results):
            raise RuntimeError(f"continuous: streamed clients failed: {errors}")
        verdicts = []
        for i, ((prompt, samp), (toks, *_rest)) in enumerate(zip(reqs, results)):
            verdicts.append(check_near_ties(server, prompt, toks, want[i],
                                            f"continuous: stream of client {i}", samp))
        ttfts = [r[1][0] * 1e3 for r in results]
        stats["cont_tps_engine"] = total / wall
        stats["cont_ttft_ms_p50"], stats["cont_ttft_ms_p99"] = _pcts(ttfts)
        stats["cont_ttft_ms_late"] = ttfts[CONT_LATE]
        log(f"continuous: {len(reqs)} streamed clients (prompts {list(CONT_PROMPTS)} + {n_new}, "
            f"odd ones sampled, client {CONT_LATE} joining mid-decode): {total} tokens in "
            f"{wall:.2f} s, {stats['cont_tps_engine']:.1f} tokens/s; TTFT p50 "
            f"{stats['cont_ttft_ms_p50']:.1f} ms, p99 {stats['cont_ttft_ms_p99']:.1f} ms, the "
            f"mid-decode join {stats['cont_ttft_ms_late']:.1f} ms; against the plain path: "
            f"{verdicts}")

        # the same requests whole, at once, with a /v1/forward while they decode
        fwd_tokens = torch.randint(0, cfg.vocab_size, (1, CONT_MAX_LEN),
                                   generator=torch.Generator().manual_seed(11)).tolist()
        whole = [None] * len(reqs)

        def whole_client(i):
            prompt, samp = reqs[i]
            status, _, body = _post(port, "/v1/generate", {"tokens": [prompt],
                                                           "max_new_tokens": n_new, **samp})
            whole[i] = (status, body)

        threads = [threading.Thread(target=whole_client, args=(i,), daemon=True)
                   for i in range(len(reqs))]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            status, body = _http(port, "/admin/models")
            if body["serving"][MODEL]["active"] >= len(reqs):
                break
            time.sleep(0.01)
        else:
            raise RuntimeError("continuous: the whole requests never all decoded at once")
        tf = time.monotonic()
        status, _, body = _post(port, "/v1/forward", {"tokens": fwd_tokens})
        stats["cont_forward_ms_decoding"] = (time.monotonic() - tf) * 1e3
        active_after = _http(port, "/admin/models")[1]["serving"][MODEL]["active"]
        if status != 200:
            raise RuntimeError(f"continuous: /v1/forward while decoding answered {status}")
        for t in threads:
            t.join(timeout=900)
        stats["cont_tps_engine_whole"] = total / (time.monotonic() - t0)
        for i, (st_, body) in enumerate(whole):
            if st_ != 200:
                raise RuntimeError(f"continuous: whole request {i} answered {st_} {body[:300]}")
            got = json.loads(body)["tokens"][0][len(reqs[i][0]):]
            if got != results[i][0]:
                raise RuntimeError(f"continuous: client {i}'s stream differs from its whole "
                                   f"answer")
        lone = []
        for _ in range(3):
            tf = time.monotonic()
            status, _, _ = _post(port, "/v1/forward", {"tokens": fwd_tokens})
            lone.append((time.monotonic() - tf) * 1e3)
        stats["cont_forward_ms_alone"] = statistics.median(lone)
        log(f"continuous: the same requests whole, at once: {stats['cont_tps_engine_whole']:.1f}"
            f" tokens/s, every stream == its whole answer; /v1/forward [1,{CONT_MAX_LEN}] while "
            f"{len(reqs)} rows decode {stats['cont_forward_ms_decoding']:.1f} ms ({active_after} "
            f"still active after it) against {stats['cont_forward_ms_alone']:.1f} ms alone")

        # resume: a sampled stream cut after RESUME_AFTER tokens, continued
        prompt, samp = reqs[RESUME_CLIENT]
        body = {"tokens": [prompt], "max_new_tokens": n_new, **samp}
        cut, _ = _stream_timed(port, body, stop_after=RESUME_AFTER)
        cut = cut[:RESUME_AFTER]
        rest, _ = _stream_timed(port, dict(body, seed=0, resume={"emitted": cut,
                                                                 "seed": samp["seed"]}))
        # its re-prefilled cut may round apart from the decoded one (bf16)
        verdict = ("equal" if cut + rest == results[RESUME_CLIENT][0] else
                   "differs; against the plain path: " + check_near_ties(
                       server, prompt, cut + rest, want[RESUME_CLIENT],
                       "continuous: the resumed stream", samp))
        log(f"continuous: a sampled stream cut after {RESUME_AFTER} tokens and resumed with "
            f"resume {{emitted, seed}}: {len(cut) + len(rest)} tokens, against the "
            f"uninterrupted stream: {verdict}")
        stats["cont_resume"] = verdict
        # an expired propagated deadline
        status, headers, body = _post(port, "/v1/generate", {"tokens": [prompt[:16]]},
                                      {"X-ModelX-Deadline-Ms": "0"})
        if status != 504 or "deadline" not in json.loads(body)["error"]:
            raise RuntimeError(f"continuous: an expired deadline answered {status} {body}")
        log("continuous: an expired X-ModelX-Deadline-Ms answered 504")
        child_flash = _stop_serve_child(proc, child_log, "continuous")
        if child_flash != per_forward * (1 + 1 + len(lone)):
            raise RuntimeError(f"continuous: the child launched the flash kernel {child_flash} "
                               f"times, want {per_forward * (2 + len(lone))} (its warm-up and "
                               f"{1 + len(lone)} forwards; none in admission or decode)")
        proc = None

        # a bounded backlog sheds with 429 + Retry-After
        # one slot: the first arrival holds it while the burst queues
        sset = ServerSet({MODEL: server}, continuous_batch=True, max_slots=1,
                         stream_chunk_size=CONT_CHUNK, max_queue_depth=QUEUE_DEPTH)
        sset.pool.mark_ready(MODEL)
        qport = _free_port()
        httpd = serve(sset, listen=f"127.0.0.1:{qport}")
        gate = threading.Barrier(QUEUE_BURST)
        burst = [None] * QUEUE_BURST

        def burst_client(i):
            gate.wait()
            burst[i] = _post(qport, "/v1/generate", {"tokens": [reqs[0][0][:16]],
                                                     "max_new_tokens": 16})

        threads = [threading.Thread(target=burst_client, args=(i,), daemon=True)
                   for i in range(QUEUE_BURST)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        shed = [b for b in burst if b is not None and b[0] == 429]
        if (not shed or any(b is None or b[0] not in (200, 429) for b in burst)
                or any("Retry-After" not in b[1] for b in shed)):
            raise RuntimeError(f"continuous: a burst of {QUEUE_BURST} at --max-queue-depth "
                               f"{QUEUE_DEPTH} answered {[b and (b[0], b[1]) for b in burst]}")
        log(f"continuous: a burst of {QUEUE_BURST} at --max-queue-depth {QUEUE_DEPTH}: "
            f"{len(shed)} answered 429 with Retry-After {shed[0][1]['Retry-After']} "
            f"({json.loads(shed[0][2])['error']}), the rest 200")
        stats["cont_shed"] = len(shed)
        httpd.shutdown()
        httpd.server_close()
        httpd = None
        for cb in sset.cbatchers.values():
            _release(cb)

        # in-process engines, one at a time: dense and paged gather at 32 slots
        outs, snaps, kv, cost = {}, {}, {}, {}
        dense_at = dict(max_slots=PAGED_SLOTS)
        paged_at = dict(max_slots=PAGED_SLOTS, page_size=PAGE_SIZE, max_live_tokens=KV_LIVE_TOKENS)
        longest = max(CONT_PROMPTS) + n_new
        for mode, kw in (("dense", dense_at), ("gather", paged_at),
                         ("in-place", dict(paged_at, paged_attention="in-place"))):
            cb = _engine(server, **kw)
            engines.append(cb)
            outs[mode], secs = no_flash(f"the {mode} engine", lambda: _engine_burst(cb, reqs))
            stats[f"cont_tps_{mode}"] = total / secs
            snaps[mode] = cb.snapshot()
            kv[mode] = cb.kv_bytes()
            cost[mode] = _step_cost(cb, len(reqs), longest, on_card)
            if mode == "dense":
                # schedule invariance: the same burst again, lockstep (one
                # chunk per dispatch, none in flight ahead) answers the
                # same bytes as the pipelined run
                depths = (cb.pipeline_depth, cb.stats["dispatch_depth_max"])
                cb.pipeline_depth, cb._depth_cap = 1, 1
                again, _ = _engine_burst(cb, reqs)
                if again != outs[mode]:
                    bad = [i for i, (a, b) in enumerate(zip(again, outs[mode])) if a != b]
                    raise RuntimeError(f"continuous: pipeline/dispatch depth 1 changed the "
                                       f"tokens of requests {bad}")
                log(f"continuous: dense engine at pipeline depth 1, dispatch depth 1 == at "
                    f"pipeline depth {depths[0]}, dispatch depth up to {depths[1]}, byte "
                    f"for byte (greedy and sampled)")
            if mode == "dense" and on_card:
                # the policed run: greedy rows only, every synchronizing
                # CUDA call warns (the sampler's filter branch syncs by design)
                greedy = [r for r in reqs if not r[1]]
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    with warnings.catch_warnings(record=True) as caught:
                        warnings.simplefilter("always")
                        d0 = cb.stats["dispatches"]
                        _engine_burst(cb, greedy)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                syncs = [str(w.message)[:120] for w in caught if "synchroniz" in str(w.message)]
                stats["cont_sync_debug_warnings"] = len(syncs)
                stats["cont_sync_debug_dispatches"] = cb.stats["dispatches"] - d0
                log(f"continuous: torch.cuda.set_sync_debug_mode('warn') over a greedy burst: "
                    f"{len(syncs)} synchronizing calls in {stats['cont_sync_debug_dispatches']} "
                    f"dispatches {sorted(set(syncs))[:3]}")
            _release(cb)
            engines.remove(cb)
            stats[f"cont_boundary_host_ms_p50_{mode}"] = snaps[mode].get("boundary_host_ms_p50")
            stats[f"cont_boundary_host_ms_p99_{mode}"] = snaps[mode].get("boundary_host_ms_p99")
            stats[f"cont_syncs_per_boundary_{mode}"] = snaps[mode]["host_syncs_per_boundary"]
            stats[f"cont_step_ops_{mode}"], stats[f"cont_step_ms_{mode}"] = (
                cost[mode]["ops"], cost[mode]["ms"])
            stats[f"cont_kv_bytes_{mode}"] = kv[mode]
            log(f"continuous: {mode} engine ({kw}): {stats[f'cont_tps_{mode}']:.1f} tokens/s; "
                f"boundary host ms p50 {snaps[mode].get('boundary_host_ms_p50')} p99 "
                f"{snaps[mode].get('boundary_host_ms_p99')}, blocking syncs per steady boundary "
                f"{snaps[mode]['host_syncs_per_boundary']}; a chunk step with {len(reqs)} rows at "
                f"{longest} positions: {cost[mode]['ops']} device operations, "
                f"{cost[mode]['ms'] and round(cost[mode]['ms'], 3)} ms; KV {kv[mode] / 1e9:.3f} GB")
        if outs["gather"] != outs["dense"]:
            bad = [i for i, (g, d) in enumerate(zip(outs["gather"], outs["dense"])) if g != d]
            raise RuntimeError(f"continuous: paged gather differs from dense on requests {bad}")
        # in place: gather's tokens, or each a near-tie on its own prefix of
        # the plain path (the reference the replay reproduces)
        inplace = ["equal" if g == gw else "against the plain path: " + check_near_ties(
                       server, p, g, w, f"continuous: in-place request {i}", s)
                   for i, ((p, s), g, gw, w) in enumerate(zip(reqs, outs["in-place"],
                                                              outs["gather"], want))]
        dense_v = [check_near_ties(server, p, d, w, f"continuous: dense request {i}", s)
                   for i, ((p, s), d, w) in enumerate(zip(reqs, outs["dense"], want))]
        log(f"continuous: gather == dense byte for byte at {PAGED_SLOTS} slots; in-place against "
            f"gather: {inplace}; dense against the plain path: {dense_v}")

        # chunked prefill: a FILL_CLIENT fill while decode rows stream. The
        # rows take twice the requests' tokens, so they outlast the fill's
        # admission (the fourth chunk after theirs starts) and its pieces
        row_new = 2 * n_new
        row_want = {i: no_flash("the plain decode", lambda i=i: server.generate(
            np.asarray([reqs[i][0]], np.int32), max_new_tokens=row_new,
            **reqs[i][1]))[0, len(reqs[i][0]):].tolist() for i in FILL_DECODE_CLIENTS}
        for chunk in (PREFILL_CHUNK, 0):
            # one chunk per dispatch: the decode rows' boundaries keep their
            # cadence until the fill arrives (a deep dispatch would have
            # planned them to their end)
            cb = _engine(server, max_slots=CONT_SLOTS, prefill_chunk=chunk, dispatch_depth=1)
            engines.append(cb)
            order = []
            if chunk:
                real_chunk, real_piece = cb._chunk, cb._piece
                cb._chunk = lambda *a: (order.append("C"), real_chunk(*a))[1]
                # "P": a piece landed while decode rows were active, "p":
                # after they ended (nothing left to interleave with)
                cb._piece = lambda *a: (order.append("P" if cb._rows else "p"),
                                        real_piece(*a))[1]
            dec = {}

            def decode_row(i):
                prompt, samp = reqs[i]
                t0 = time.monotonic()
                toks, times = [], []
                for piece in cb.stream(np.asarray([prompt], np.int32),
                                       max_new_tokens=row_new, **samp):
                    toks.extend(piece[0].tolist())
                    times.append(time.monotonic())
                dec[i] = (toks, times)

            threads = [threading.Thread(target=decode_row, args=(i,), daemon=True)
                       for i in FILL_DECODE_CLIENTS]
            for t in threads:
                t.start()
            chunks0 = cb.stats["chunks"]
            deadline = time.monotonic() + 300
            while cb.stats["chunks"] - chunks0 < 2 and time.monotonic() < deadline:
                time.sleep(0.001)
            prompt, samp = reqs[FILL_CLIENT]
            t_fill = time.monotonic()
            fill = no_flash("the fill", lambda: list(cb.stream(
                np.asarray([prompt], np.int32), max_new_tokens=n_new, **samp)))
            for t in threads:
                t.join(timeout=600)
            fill_toks = np.concatenate(fill, axis=1)[0].tolist()
            v = check_near_ties(server, prompt, fill_toks, want[FILL_CLIENT],
                                f"continuous: the {len(prompt)}-token fill", samp)
            gaps = []
            for i, (toks, times) in dec.items():
                check_near_ties(server, reqs[i][0], toks, row_want[i],
                                f"continuous: decode row {i}", reqs[i][1])
                gaps += [b - a for a, b in zip(times, times[1:]) if b > t_fill]
            key = f"cont_fill_gap_ms_{'chunked' if chunk else 'monolithic'}"
            stats[key] = max(gaps) * 1e3 if gaps else None
            seq = "".join(order)
            if chunk and (seq.lower().count("p") != -(-len(prompt) // chunk)
                          or "P" not in seq or "PP" in seq):
                raise RuntimeError(f"continuous: the fill skipped a decode boundary: {seq}")
            log(f"continuous: a {len(prompt)}-token fill with prefill_chunk {chunk} while "
                f"{len(FILL_DECODE_CLIENTS)} rows decode: longest gap between a decode row's "
                f"tokens {stats[key]:.1f} ms; fill tokens against the plain path: {v}"
                + (f"; boundaries {seq}" if chunk else ""))
            _release(cb)
            engines.remove(cb)

        # speculation inside the engine: a lone greedy row on the options
        # phase's self-repeating prompt, against plain greedy and against
        # models/speculative.py's decoder on the same params
        from modelx_tpu_torch.models.speculative import SpeculativeDecoder

        prompt, spec_new = spec_prompt(cfg), SPEC_NEW_TOKENS
        plain = no_flash("the plain decode", lambda: server.generate(
            np.asarray([prompt], np.int32), max_new_tokens=spec_new))[0, len(prompt):].tolist()
        with torch.inference_mode():
            dec_toks, dec = no_flash("the speculative decoder", lambda: SpeculativeDecoder(
                *server.family.decode_fns(server.params, server.cfg), k=SPEC_K).generate(
                    server.params, prompt, spec_new))
        cb = _engine(server, max_slots=CONT_SLOTS, speculative_k=SPEC_K)
        engines.append(cb)
        got = no_flash("the speculating engine", lambda: cb.generate(
            np.asarray([prompt], np.int32), max_new_tokens=spec_new))[0, len(prompt):].tolist()
        v = check_near_ties(server, prompt, got, plain, "continuous: speculation")
        snap = cb.snapshot()
        steps, proposed, accepted = (snap.get(k, 0) for k in
                                     ("spec_steps", "spec_proposed", "spec_accepted"))
        # the same tokens from the same history are the same proposals and
        # accepts; elsewhere a near-tie moved the history, not the rate
        if got == dec_toks and (proposed, accepted) != (dec["proposed"], dec["accepted"]):
            raise RuntimeError(f"continuous: the engine's speculation proposed/accepted "
                               f"{proposed}/{accepted}, the decoder's {dec['proposed']}/"
                               f"{dec['accepted']} for the same tokens")
        if not steps or accepted < CONT_SPEC_MIN_RATE * proposed:
            raise RuntimeError(f"continuous: the engine accepted {accepted} of {proposed} "
                               f"proposals in {steps} verify steps (want at least "
                               f"{CONT_SPEC_MIN_RATE} of them)")
        stats["cont_spec_accept_rate"] = accepted / proposed
        log(f"continuous: speculative_k {SPEC_K} on a lone greedy row, a {SPEC_PERIOD}-token "
            f"period x {SPEC_REPEATS} prompt + {spec_new}: {steps} verify steps, {accepted}/"
            f"{proposed} accepted (the decoder: {dec['accepted']}/{dec['proposed']}, tokens "
            f"{'equal' if got == dec_toks else 'differ'}); against plain greedy: {v}")
        _release(cb)
        engines.remove(cb)
        inproc = attn.flash_attention.launches
        if inproc != warm or warm != per_forward:
            raise RuntimeError(f"continuous: in-process launches {inproc}, want only the "
                               f"warm-up's {per_forward}")
        stats["flash_launches_continuous"] = inproc + child_flash
        return stats
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        for cb in engines:
            _release(cb)
        _free(server)


# -- phase 11: the other generative families -----------------------------------------

FAMILY_FORWARD_LEN = 2048  # /v1/forward [1, S]; gpt2 at its n_positions
FAMILY_PROMPT, FAMILY_NEW = 128, 32
FAMILY_SAMPLED = {"temperature": 0.8, "seed": 17}
# gemma2: a forward and a decode past its 4096-key sliding window
GEMMA_LONG_FORWARD = 6144
GEMMA_LONG_PROMPT, GEMMA_LONG_NEW = 4500, 16
# gemma2 through the continuous engine: clients (odd ones sampled), slots,
# and the page size of the in-process paged engines (64-token pages keep
# the in-place loop at 17 blocks a step for a 1032-token row)
GEMMA_ENGINE_PROMPTS = (128, 512, 1000, 128)
GEMMA_ENGINE_SLOTS, GEMMA_PAGE_SIZE = 4, 64
# Mixtral-8x7B's depth cut: all 32 layers take 93.4 GB in bf16, more than
# the card's 80; every layer is of one kind, so 2 keep the pattern (4 until
# the objectstore path joined the smoke's time limit)
MIXTRAL_LAYERS = 2
# Gemma-2-9B's depth cut, for the smoke's time limit: 6 of its 42 layers
# keep the alternation of windowed (even) and global (odd) layers (10 until
# the train phase joined the smoke, 14 before the objectstore path)
GEMMA_LAYERS = 6
# Phi-3-mini-4k's depth cut, for the smoke's time limit: 8 of its 32 layers
# (32 until the train phase joined the smoke). The objectstore path pushes,
# pulls and hashes its checkpoint, so its seconds follow the bytes: 2.2 GB
# here, 7.64 GB at full depth
PHI3_LAYERS = 8


def family_configs() -> list:
    """(family, config) of each checkpoint the phase writes, in order:
    Gemma-2-9B at ``GEMMA_LAYERS`` layers, Phi-3-mini-4k at ``PHI3_LAYERS``
    (head_dim 96),
    Mixtral-8x7B at ``MIXTRAL_LAYERS`` layers, GPT-2 125M, every one bf16;
    then BERT-base in fp32, as HF ships it."""
    import dataclasses

    import torch

    from modelx_tpu_torch.models import bert, gemma2, gpt2, llama, mixtral

    phi3_mini = llama.LlamaConfig(vocab_size=32064, hidden_size=3072, intermediate_size=8192,
                                  num_layers=PHI3_LAYERS, num_heads=32, num_kv_heads=32,
                                  head_dim=96, rope_theta=10000.0, rms_eps=1e-5)
    return [
        ("gemma2", dataclasses.replace(gemma2.Gemma2Config.gemma2_9b(),
                                       num_layers=GEMMA_LAYERS)),
        ("phi3", phi3_mini),
        ("mixtral", dataclasses.replace(mixtral.MixtralConfig.mixtral_8x7b(),
                                        num_layers=MIXTRAL_LAYERS)),
        ("gpt2", dataclasses.replace(gpt2.GPT2Config.gpt2_125m(), dtype=torch.bfloat16)),
        ("bert", bert.BertConfig.bert_base()),
    ]


def hf_expert_layout(params: dict) -> dict:
    """Stacked ``...experts.wN.weight`` [E, ...] tensors as HF's per-expert
    ``...experts.<i>.wN.weight`` entries (views), the layout the loader
    folds back (``dl/loader.fuse_expert_tensors``)."""
    out = {}
    for name, t in params.items():
        m = re.match(r"^(.+\.experts)\.(w[123])\.weight$", name)
        if m:
            out.update({f"{m.group(1)}.{i}.{m.group(2)}.weight": t[i] for i in range(t.shape[0])})
        else:
            out[name] = t
    return out


def _kernel_vs_plain(server, module, tokens, got: list, what: str) -> str:
    """The kernel path's argmax (``got``, from /v1/forward) against the same
    forward through the plain attention on the same device: equal, or each
    differing position's token within ``OPTIONS_TIE_TOL`` of the plain
    logits' maximum there."""
    import torch

    def plain():
        with torch.inference_mode():
            t = torch.as_tensor(tokens, dtype=torch.int64).to(server.device)
            logits = module.forward(server.params, t, server.cfg, attention_impl="reference")[0]
            g = torch.as_tensor(got, dtype=torch.int64).to(server.device)
            gaps = logits.max(-1).values.float() - logits.gather(-1, g[..., None])[..., 0].float()
            finite = bool(torch.isfinite(logits).all())
            return (logits.argmax(-1) != g).sum().item(), gaps.max().item(), finite

    n_diff, worst, finite = _uncounted(plain)
    if not finite:
        raise RuntimeError(f"{what}: non-finite logits through the plain attention")
    if worst > OPTIONS_TIE_TOL:
        raise RuntimeError(f"{what}: {n_diff} positions differ from the plain attention's "
                           f"argmax, one {worst:.4f} below its maximum (tolerance "
                           f"{OPTIONS_TIE_TOL})")
    return ("equal to the plain attention's argmax" if n_diff == 0 else
            f"{n_diff} positions differ from the plain attention's argmax, each within "
            f"{worst:.4f} of its maximum")


def _layer0_attention_vs_plain(server, tokens, what: str) -> str:
    """Mixtral: the top-2 router turns a bf16 rounding difference between
    two attention paths into another expert, so their logits are not
    near-ties of each other. The kernel is held instead on layer 0's own
    q, k and v against the plain version in fp32, within the kernels
    phase's bf16 tolerance (``TOL``)."""
    import torch
    import torch.nn.functional as F

    from modelx_tpu_torch.models import llama
    from modelx_tpu_torch.ops import attention as attn
    from modelx_tpu_torch.ops.nn import linear

    cfg, p = server.cfg, server.params

    def compare():
        with torch.inference_mode():
            t = torch.as_tensor(tokens, dtype=torch.int64).to(server.device)
            b, s = t.shape
            positions = llama.positions_for(t, False)
            x = F.embedding(t, p["model.embed_tokens.weight"]).to(cfg.dtype)
            h = llama._rms_norm(x, p["model.layers.0.input_layernorm.weight"], cfg.rms_eps)
            qkv = []
            for name, heads in (("q", cfg.num_heads), ("k", cfg.num_kv_heads),
                                ("v", cfg.num_kv_heads)):
                y = linear(h, p[f"model.layers.0.self_attn.{name}_proj.weight"])
                y = y.reshape(b, s, heads, cfg.head_dim)
                y = y if name == "v" else llama._rope(y, positions, cfg.rope_theta)
                qkv.append(y.transpose(1, 2).contiguous())
            out = attn.flash_attention(*qkv, causal=True).float()
            ref = attn.attention_reference(*(y.float() for y in qkv), causal=True)
            atol, rtol = TOL["bfloat16"]
            diff = (out - ref).abs()
            return float(diff.max()), bool((diff <= atol + rtol * ref.abs()).all())

    err, ok = _uncounted(compare)
    if not ok:
        raise RuntimeError(f"{what}: layer 0's attention through the kernel differs from the "
                           f"plain version by {err:.3e}")
    return f"layer 0's attention within the bf16 tolerance of the plain version ({err:.3e})"


def phase_families(device: str = "cuda", configs: list | None = None,
                   objectstore: bool = True) -> dict:
    """The other generative families (module docstring, phase 11): one
    seeded random checkpoint at a time (``family_configs``), written with
    the port's writer, served by ``serve_main``, and deleted before the
    next. Its flash launches are counted from 0, each family's in turn.
    With ``objectstore``, phi3's checkpoint then takes the objectstore path
    (``phase_objectstore``, its launches counted from 0 apart), and phi3's
    int8 check reads the pulled copy."""
    import gc
    import importlib
    import shutil

    import numpy as np
    import torch

    from modelx_tpu_torch.dl import safetensors as st
    from modelx_tpu_torch.dl import serve_main
    from modelx_tpu_torch.ops import attention as attn

    stats: dict = {}
    on_card = device == "cuda"
    attn.flash_attention.launches = 0  # the families path's own count
    child_flash = 0
    for seed, (name, cfg) in enumerate(configs or family_configs()):
        if name == "bert":  # the encoder: forwards only (phase_bert)
            launches0 = attn.flash_attention.launches
            stats.update(phase_bert(cfg, device, seed))
            stats["fam_bert_launches"] = attn.flash_attention.launches - launches0
            if stats["fam_bert_launches"]:
                raise RuntimeError(f"families: bert launched the flash kernel "
                                   f"{stats['fam_bert_launches']} times, want 0 (its "
                                   f"attention is the plain reference, as in JAX)")
            continue
        module = importlib.import_module(f"modelx_tpu_torch.models.{name}")
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        nbytes = 2 * sum(math.prod(s) for s in module.param_shapes(cfg).values())
        ckpt = _checkpoint_dir(nbytes)
        httpd = proc = None
        servers = []
        try:
            t0 = time.monotonic()
            params = module.init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                                        dtype=torch.bfloat16)
            w1 = "model.layers.0.block_sparse_moe.experts.w1.weight"
            written = hf_expert_layout(params) if name == "mixtral" else params
            st.write_safetensors(os.path.join(ckpt, "model.safetensors"), written)
            stacked = params[w1] if name == "mixtral" else None
            del params, written
            if name in FAMILY_TOKENIZERS:
                t0 = time.monotonic()
                with open(os.path.join(ckpt, "tokenizer.json"), "w", encoding="utf-8") as f:
                    f.write(FAMILY_TOKENIZERS[name](cfg.vocab_size))
                log(f"families: {name}: wrote its tokenizer.json in "
                    f"{time.monotonic() - t0:.1f} s")
            log(f"families: {name}: wrote a seeded random checkpoint ({cfg}; {nbytes / 1e9:.3f} "
                f"GB{', HF per-expert layout' if name == 'mixtral' else ''}) in "
                f"{time.monotonic() - t0:.1f} s")

            launches0 = attn.flash_attention.launches
            has_kernel = name != "gpt2"  # gpt2's attention is the plain reference, as in JAX
            per_forward = cfg.num_layers if on_card and has_kernel else 0
            port = _free_port()
            sset, httpd = serve_main.start([
                "--model", f"{name}={ckpt}", "--listen", f"127.0.0.1:{port}", "--device", device,
                "--dtype", "bfloat16", "--max-seq-len", str(CONT_MAX_LEN)])
            server = sset.servers[name]
            servers.append(server)
            if server.cfg != cfg:
                raise RuntimeError(f"families: {name}: inferred config {server.cfg} is not the "
                                   f"written {cfg}")
            if stacked is not None:
                if not torch.equal(server.params[w1], stacked):
                    raise RuntimeError("families: mixtral: the loader's fused expert tensor "
                                       "differs from the per-expert tensors written")
                del stacked
            s = server.stats
            stats[f"fam_{name}_load_gbps"] = s["load_gbps"]
            rng = torch.Generator().manual_seed(100 + seed)
            flen = min(FAMILY_FORWARD_LEN, getattr(cfg, "n_positions", FAMILY_FORWARD_LEN))
            tokens = torch.randint(0, cfg.vocab_size, (1, flen), generator=rng).tolist()
            fwd_ms = []
            for _ in range(2):
                before = attn.flash_attention.launches
                t0 = time.monotonic()
                status, body = _http(port, "/v1/forward", {"tokens": tokens})
                fwd_ms.append((time.monotonic() - t0) * 1e3)
                if status != 200 or np.asarray(body["logits_argmax"]).shape != (1, flen):
                    raise RuntimeError(f"families: {name}: /v1/forward answered {status} "
                                       f"{str(body)[:300]}")
                if attn.flash_attention.launches - before != per_forward:
                    raise RuntimeError(f"families: {name}: /v1/forward launched the kernel "
                                       f"{attn.flash_attention.launches - before} times, want "
                                       f"{per_forward}")
            got = body["logits_argmax"]
            stats[f"fam_{name}_forward_ms"] = fwd_ms[1]
            if name == "mixtral":
                vs_plain = _layer0_attention_vs_plain(server, tokens, "families: mixtral")
            elif has_kernel:
                vs_plain = _kernel_vs_plain(server, module, tokens, got, f"families: {name}")
            else:
                vs_plain = "none on this family's path"

            prompt = torch.randint(0, cfg.vocab_size, (1, FAMILY_PROMPT), generator=rng).tolist()
            body = {"tokens": prompt, "max_new_tokens": FAMILY_NEW}
            before = attn.flash_attention.launches
            t0 = time.monotonic()
            status, out = _http(port, "/v1/generate", body)
            secs = time.monotonic() - t0
            if status != 200 or len(out["tokens"][0]) != FAMILY_PROMPT + FAMILY_NEW:
                raise RuntimeError(f"families: {name}: /v1/generate answered {status} "
                                   f"{str(out)[:300]}")
            greedy = out["tokens"][0][FAMILY_PROMPT:]
            stats[f"fam_{name}_greedy_tps"] = FAMILY_NEW / secs
            streamed, _, _ = _stream(port, body)
            if streamed != greedy:
                raise RuntimeError(f"families: {name}: the NDJSON stream differs from the "
                                   f"whole answer")
            sampled = [_sampled(port, {**body, **FAMILY_SAMPLED}, FAMILY_PROMPT, FAMILY_NEW)[0]
                       for _ in range(2)]
            if sampled[0] != sampled[1]:
                raise RuntimeError(f"families: {name}: a seeded sampled request did not repeat")
            if attn.flash_attention.launches != before:
                raise RuntimeError(f"families: {name}: generation launched the cache-free "
                                   f"kernel")
            log(f"families: {name}: load {s['load_bytes'] / 1e9:.3f} GB in {s['load_seconds']} s, "
                f"{s['load_gbps']} GB/s; /v1/forward [1,{flen}] {fwd_ms[1]:.1f} ms (first "
                f"{fwd_ms[0]:.1f}), kernel {vs_plain}; greedy {FAMILY_PROMPT} + {FAMILY_NEW} "
                f"{stats[f'fam_{name}_greedy_tps']:.1f} tokens/s; the stream == the whole "
                f"answer; a seeded sampled request repeats")

            if name in FAMILY_TOKENIZERS:
                t0 = time.monotonic()
                stats.update(family_text(name, port, server, cfg, per_forward))
                stats[f"fam_{name}_text_s"] = time.monotonic() - t0
                log(f"families: {name}: the text checks took {stats[f'fam_{name}_text_s']:.1f} s")
                # the objectstore path moves the weights alone
                os.remove(os.path.join(ckpt, "tokenizer.json"))
            if name == "phi3" and objectstore:
                # the path takes the checkpoint (it deletes it before its
                # pull) with this server freed; phi3's int8 check then reads
                # the pulled copy
                httpd.shutdown()
                httpd.server_close()
                httpd = None
                _free(*servers)
                servers = []
                so_far = attn.flash_attention.launches - launches0
                stats.update(phase_objectstore(ckpt, device, tokens, got, per_forward))
                ckpt = ckpt + "-pulled"  # the finally deletes it
                # phi3's count goes on from where it stood before the path
                launches0 = attn.flash_attention.launches - so_far
            extra = {"gemma2": _gemma2_extra, "phi3": _phi3_extra,
                     "gpt2": _gpt2_extra}.get(name)
            child = 0
            if extra is not None:
                stats_x, child, httpd = extra(sset, httpd, server, module, cfg, ckpt,
                                             device, per_forward, rng)
                stats.update(stats_x)
                child_flash += child
            stats[f"fam_{name}_launches"] = attn.flash_attention.launches - launches0
            log(f"families: {name}: flash_attention launches {stats[f'fam_{name}_launches']}"
                f" in-process{f', {child} in the engine child' if name == 'gemma2' else ''}")
        finally:
            if httpd is not None:
                httpd.shutdown()
                httpd.server_close()
            _free(*servers)
            if ckpt:
                shutil.rmtree(ckpt, ignore_errors=True)
    # each family's count from its own start; the objectstore path's apart
    stats["flash_launches_families"] = child_flash + sum(
        v for k, v in stats.items() if k.startswith("fam_") and k.endswith("_launches"))
    return stats


BERT_FORWARD_SHAPES = ((1, 512), (8, 512))
BERT_CHECK_LEN = 128
# the card's fp32 features against the CPU's on the same weights: TF32 is
# off, so the two differ only in accumulation order through 12 post-LN
# layers (unit-variance features)
BERT_FEATURE_TOL = 1e-3


def phase_bert(cfg, device: str, seed: int) -> dict:
    """BERT-base (module docstring, phase 11), seeded random fp32 weights
    written with the port's writer and served by ``serve_main``: the
    inferred config equals the written one; ``/v1/forward`` at
    ``BERT_FORWARD_SHAPES`` (timed), its features at [1, BERT_CHECK_LEN]
    against the port's fp32 forward on the CPU over the same weights
    within ``BERT_FEATURE_TOL``; ``/v1/generate`` refused with the JAX
    sidecar's 400; a forward one past the position table refused with
    gpt2's 400 before any device work, and a forward after it answers (the
    CUDA context survived). The caller checks that no kernel launched."""
    import shutil

    import numpy as np
    import torch

    from modelx_tpu_torch.dl import safetensors as st
    from modelx_tpu_torch.dl import serve_main
    from modelx_tpu_torch.models import bert

    stats: dict = {}
    nbytes = 4 * sum(math.prod(s) for s in bert.param_shapes(cfg).values())
    ckpt = _checkpoint_dir(nbytes)
    httpd = None
    servers = []
    try:
        t0 = time.monotonic()
        params = bert.init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                                  dtype=torch.float32)
        path = os.path.join(ckpt, "model.safetensors")
        st.write_safetensors(path, params)
        del params
        stats["fam_bert_write_s"] = time.monotonic() - t0
        stats["fam_bert_bytes"] = os.path.getsize(path)
        port = _free_port()
        sset, httpd = serve_main.start([
            "--model", f"bert={ckpt}", "--listen", f"127.0.0.1:{port}", "--device", device,
            "--dtype", "float32", "--max-seq-len", str(cfg.max_position_embeddings)])
        server = sset.servers["bert"]
        servers.append(server)
        if server.cfg != cfg:
            raise RuntimeError(f"families: bert: inferred config {server.cfg} is not the "
                               f"written {cfg}")
        s = server.stats
        stats["fam_bert_load_gbps"] = s["load_gbps"]
        rng = torch.Generator().manual_seed(100 + seed)
        for shape in BERT_FORWARD_SHAPES:
            tokens = torch.randint(0, cfg.vocab_size, shape, generator=rng).tolist()
            ms = []
            for _ in range(2):
                t0 = time.monotonic()
                status, body = _http(port, "/v1/forward", {"tokens": tokens})
                ms.append((time.monotonic() - t0) * 1e3)
                if status != 200 or np.asarray(body["logits_argmax"]).shape != shape:
                    raise RuntimeError(f"families: bert: /v1/forward {list(shape)} answered "
                                       f"{status} {str(body)[:300]}")
            stats[f"fam_bert_forward_ms_{shape[0]}x{shape[1]}"] = ms[1]
            stats[f"fam_bert_forward_ms_{shape[0]}x{shape[1]}_first"] = ms[0]

        # the card's features against the CPU's fp32 forward on the same weights
        tokens = torch.randint(0, cfg.vocab_size, (1, BERT_CHECK_LEN), generator=rng)
        host = {k: v.cpu() for k, v in st.read_tensors(path).items()}
        with torch.inference_mode():
            card_seq, card_pool = (t.float().cpu() for t in bert.forward(
                server.params, tokens.to(server.device), server.cfg))
            cpu_seq, cpu_pool = bert.forward(host, tokens, cfg)
        err = max(float((card_seq - cpu_seq).abs().max()),
                  float((card_pool - cpu_pool).abs().max()))
        finite = bool(torch.isfinite(card_seq).all() and torch.isfinite(card_pool).all())
        if not finite or err > BERT_FEATURE_TOL:
            raise RuntimeError(f"families: bert: features differ from the CPU's by {err:.3e} "
                               f"(tolerance {BERT_FEATURE_TOL}; finite {finite})")
        stats["fam_bert_feature_err"] = err
        del host

        status, body = _http(port, "/v1/generate", {"tokens": tokens.tolist(),
                                                    "max_new_tokens": 4})
        if (status, body) != (400, {"error": "family bert is not generative"}):
            raise RuntimeError(f"families: bert: /v1/generate answered {status} {body}")
        n = cfg.max_position_embeddings
        status, body = _http(port, "/v1/forward", {"tokens": [[1] * (n + 1)]})
        want = f"prompt length {n + 1} exceeds the model's {n}-position context"
        if (status, body) != (400, {"error": want}):
            raise RuntimeError(f"families: bert: a {n + 1}-token forward answered {status} {body}")
        status, body = _http(port, "/v1/forward", {"tokens": [[1] * n]})
        if status != 200:
            raise RuntimeError(f"families: bert: the forward after the refusal answered "
                               f"{status} {str(body)[:200]}")
        log(f"families: bert: wrote {stats['fam_bert_bytes'] / 1e9:.3f} GB fp32 in "
            f"{stats['fam_bert_write_s']:.1f} s; load {s['load_seconds']} s "
            f"({s['load_gbps']} GB/s); /v1/forward "
            + ", ".join(f"{list(sh)} {stats[f'fam_bert_forward_ms_{sh[0]}x{sh[1]}']:.1f} ms "
                        f"(first {stats[f'fam_bert_forward_ms_{sh[0]}x{sh[1]}_first']:.1f})"
                        for sh in BERT_FORWARD_SHAPES)
            + f"; features [1,{BERT_CHECK_LEN}] within {err:.2e} of the CPU's fp32 forward; "
            f"/v1/generate refused as the JAX sidecar refuses it; a {n + 1}-token forward "
            f"answered 400 and the next forward 200")
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        _free(*servers)
        shutil.rmtree(ckpt, ignore_errors=True)
    return stats


# -- the families' tokenizer.json files (inside phase 11) -----------------------------

# gemma2 serves a Unigram file in the T5/XLM-R layout, phi3 a byte-level BPE
# file with Digits, Punctuation and padding. The ids the card's host
# encodes for FAMILY_TEXTS are held to these digests, which
# tests/test_torch_chip_smoke.py holds to the ``tokenizers`` package's ids
# for the same files (the card's host has no ``tokenizers``); the tiny vocab
# sizes are the CPU rehearsal's
FAMILY_TEXT_DIGESTS = {
    ("gemma2", 256000): "f4b3334531f187e6b0e8cc8b9978122a1484d0f0ac22e950e124b6faa08fea5f",
    ("gemma2", 256): "615ee35e6f5c49c350fb12148741171da67ea5b96f7a7ccb9d57f220e2ce42fc",
    ("phi3", 32064): "c45dfd56e434c54db0e692407dc9d0c1a9fc00277f436c4dee7dc855d58c21bb",
    ("phi3", 1024): "422114da292e30d1ed01e704f5cbd0dbe7f477444f3f3c40eac60acda49542c2",
}
UNIGRAM_SPECIALS = ("<s>", "<pad>", "</s>", "<unk>")
# a cut of a T5-style nmt_nfkc charsmap: compatibility forms, quotes, the
# spaces and a composed accent
FAMILY_CHARSMAP = {
    **{chr(0xFF01 + i): chr(0x21 + i) for i in range(94)},
    "ﬀ": "ff", "ﬁ": "fi", "ﬂ": "fl", "…": "...", "“": '"', "”": '"', "‘": "'", "’": "'",
    " ": " ", "　": " ", "\t": " ", "\n": " ", "é": "é", "①": "1", "②": "2",
}
# the gemma2 file's truncation: the long prompt is cut to this many ids,
# <s> and </s> included
GEMMA_TRUNCATE = 96
FAMILY_TEXT_PROMPT = " ".join([TEXT_PROMPT, CHAT_MESSAGES[1]["content"]] * 4)
FAMILY_TEXT_NEW = 16
FAMILY_TEXTS = (
    TEXT_PROMPT, FAMILY_TEXT_PROMPT, "ﬁne  “quoted”  café\tand ＡＢＣ… ①②",
    "ét xé́y á̂̃b", "3.14159, 2024-05-01: call 555-0100 now!",
    "Emoji 👩‍💻 and flags 🇫🇷🇩🇪 in 안녕하세요 and 日本語のテキスト\r\n",
    "The Kernel SERVES tokens; don't stop.",
)


def unigram_tokenizer_json(vocab_size: int = 256000) -> str:
    """A Unigram tokenizer.json in the T5/XLM-R layout with ``vocab_size``
    pieces: the four specials, ``▁``, printable ASCII, the words of
    ``ENGLISH`` (bare, capitalized, after ``▁``), then letter strings in a
    fixed order, each with a score from its length and place (the same
    file every time); ``Sequence[Precompiled(FAMILY_CHARSMAP),
    Replace(" {2,}", " ")]``, ``Metaspace`` (prepend "always") on both
    sides, a ``<s> $A </s>`` template and a ``truncation`` block at
    ``GEMMA_TRUNCATE``."""
    import itertools

    from modelx_tpu_torch.testing.charsmap import write_charsmap

    pieces: dict[str, float] = {p: 0.0 for p in UNIGRAM_SPECIALS}

    def add(piece: str, score: float) -> None:
        if piece not in pieces and len(pieces) < vocab_size:
            pieces[piece] = round(score, 4)

    add("▁", -2.0)
    for c in map(chr, range(0x21, 0x7F)):
        add(c, -8.0 - 0.01 * (ord(c) % 7))
    for i, w in enumerate(ENGLISH):
        for j, word in enumerate((w, w.capitalize())):
            add("▁" + word, -3.0 - 0.25 * j - 0.001 * i)
            add(word, -5.0 - 0.25 * j - 0.001 * i)
    letters = "etaoinshrdlcumwfgypbvkjxqz"
    for n in itertools.count(2):
        for k, combo in enumerate(itertools.product(letters, repeat=n)):
            if len(pieces) >= vocab_size:
                break
            add("▁" + "".join(combo), -4.0 - 0.5 * n - 0.0001 * (k % 997))
            add("".join(combo), -6.0 - 0.5 * n - 0.0001 * (k % 991))
        if len(pieces) >= vocab_size:
            break
    seq = {"Sequence": {"id": "A", "type_id": 0}}
    ids = {p: i for i, p in enumerate(pieces)}
    meta = {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always", "split": True}
    spec = {
        "version": "1.0",
        "truncation": {"direction": "Right", "max_length": GEMMA_TRUNCATE,
                       "strategy": "LongestFirst", "stride": 0},
        "padding": None,
        "added_tokens": [
            {"id": ids[c], "content": c, "single_word": False, "lstrip": False, "rstrip": False,
             "normalized": False, "special": True} for c in UNIGRAM_SPECIALS],
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Precompiled", "precompiled_charsmap": write_charsmap(FAMILY_CHARSMAP)},
            {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]},
        "pre_tokenizer": meta,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}}, seq,
                       {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}}, seq,
                     {"SpecialToken": {"id": "</s>", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 1}},
                     {"SpecialToken": {"id": "</s>", "type_id": 1}}],
            "special_tokens": {c: {"id": c, "ids": [ids[c]], "tokens": [c]}
                               for c in ("<s>", "</s>")}},
        "decoder": meta,
        "model": {"type": "Unigram", "unk_id": ids["<unk>"], "byte_fallback": False,
                  "vocab": [[p, s] for p, s in pieces.items()]},
    }
    return json.dumps(spec, ensure_ascii=False)


def padded_tokenizer_json(vocab_size: int = 32064) -> str:
    """``llama3_tokenizer_json`` at ``vocab_size`` ids in all (its 256
    specials last) with ``Digits`` (one piece a digit) and ``Punctuation``
    (contiguous) ahead of its Split, and a ``padding`` block: the longest
    (a single encode: itself) up to a multiple of 8 with
    ``<|end_of_text|>``."""
    spec = json.loads(llama3_tokenizer_json(vocab_size - len(LLAMA3_SPECIALS)))
    spec["pre_tokenizer"]["pretokenizers"][:0] = [
        {"type": "Digits", "individual_digits": True},
        {"type": "Punctuation", "behavior": "Contiguous"}]
    pad = next(t for t in spec["added_tokens"] if t["content"] == "<|end_of_text|>")
    spec["padding"] = {"strategy": "BatchLongest", "direction": "Right", "pad_to_multiple_of": 8,
                       "pad_id": pad["id"], "pad_type_id": 0, "pad_token": pad["content"]}
    return json.dumps(spec, ensure_ascii=False)


FAMILY_TOKENIZERS = {"gemma2": unigram_tokenizer_json, "phi3": padded_tokenizer_json}


def family_ids_digest(encode) -> str:
    """sha256 of the ids ``encode`` gives each of ``FAMILY_TEXTS`` (special
    tokens added), as compact JSON."""
    import hashlib

    ids = [list(encode(t)) for t in FAMILY_TEXTS]
    return hashlib.sha256(json.dumps(ids, separators=(",", ":")).encode()).hexdigest()


def family_text(name: str, port: int, server, cfg, per_forward: int) -> dict:
    """The family's tokenizer.json through the port's reader on the card's
    host: its load and encode rate, the ids of ``FAMILY_TEXTS`` against
    ``FAMILY_TEXT_DIGESTS``, text on /v1/generate == the token request,
    and (gemma2) a ``logprobs`` completion over the truncated prompt that
    launches the flash kernel ``per_forward`` times; (phi3) the padding."""
    import numpy as np

    from modelx_tpu_torch.ops import attention as attn

    stats: dict = {}
    t0 = time.monotonic()
    tok = server.tokenizer()
    if tok is None:
        raise RuntimeError(f"families: {name}: the tokenizer.json did not load")
    stats[f"fam_{name}_tokenizer_load_ms"] = (time.monotonic() - t0) * 1e3
    rates = []
    for _ in range(2):  # the first pass fills the per-word caches
        t0 = time.monotonic()
        n_corpus = sum(len(tok.encode(t)) for t in FAMILY_TEXTS * 40)
        rates.append(n_corpus / (time.monotonic() - t0))
    stats[f"fam_{name}_encode_tokens_per_s_first"], stats[f"fam_{name}_encode_tokens_per_s"] = rates
    digest = family_ids_digest(tok.encode)
    want = FAMILY_TEXT_DIGESTS.get((name, cfg.vocab_size))
    if digest != want:
        raise RuntimeError(f"families: {name}: the ids of FAMILY_TEXTS hash to {digest}, not the "
                           f"reference's {want}")
    log(f"families: {name}: tokenizer.json ({cfg.vocab_size} ids) read by the port in "
        f"{stats[f'fam_{name}_tokenizer_load_ms']:.1f} ms; encode {rates[0]:.0f} tokens/s "
        f"first pass, {rates[1]:.0f} warm ({n_corpus} tokens); ids == the tokenizers "
        f"package's (digest {digest[:12]})")

    ids = tok.encode(FAMILY_TEXT_PROMPT)
    body = {"max_new_tokens": FAMILY_TEXT_NEW}
    status, by_text = _http(port, "/v1/generate", {"text": FAMILY_TEXT_PROMPT, **body})
    _, by_ids = _http(port, "/v1/generate", {"tokens": [ids], **body})
    if status != 200 or by_text["tokens"] != by_ids["tokens"] or by_text["tokens"][0][
            :len(ids)] != ids:
        raise RuntimeError(f"families: {name}: text on /v1/generate differs from the token "
                           f"request: {str(by_text)[:300]}")
    if by_text["text"] != tok.decode(by_text["tokens"][0][len(ids):]):
        raise RuntimeError(f"families: {name}: the text answer is not the decode of its new "
                           f"tokens")
    if name == "phi3":
        pad = tok._tok.token_to_id("<|end_of_text|>")
        if len(ids) % 8 or ids[-1] != pad:
            raise RuntimeError(f"families: phi3: the prompt's {len(ids)} ids are not padded "
                               f"to a multiple of 8 with {pad}")
        stats["fam_phi3_padded_ids"] = len(ids)
        log(f"families: phi3: text /v1/generate == tokens; the prompt padded to {len(ids)} ids")
        return stats
    if len(ids) != GEMMA_TRUNCATE:
        raise RuntimeError(f"families: gemma2: the prompt encodes to {len(ids)} ids, not the "
                           f"truncation's {GEMMA_TRUNCATE}")
    before = attn.flash_attention.launches
    scored, secs = _openai(port, "/v1/completions", {
        "prompt": FAMILY_TEXT_PROMPT, "max_tokens": FAMILY_TEXT_NEW, "temperature": 0,
        "seed": 0, "ignore_eos": True, "logprobs": 5})
    rose = attn.flash_attention.launches - before
    if rose != per_forward:
        raise RuntimeError(f"families: gemma2: logprobs launched flash_attention {rose} times, "
                           f"want {per_forward} (one scoring forward)")
    values = np.asarray(scored["choices"][0]["logprobs"]["token_logprobs"], np.float64)
    if scored["usage"]["prompt_tokens"] != GEMMA_TRUNCATE or len(values) != FAMILY_TEXT_NEW or (
            not np.isfinite(values).all()) or (values > 0).any():
        raise RuntimeError(f"families: gemma2: bad logprobs answer {str(scored)[:300]}")
    stats["fam_gemma2_logprobs_s"] = secs
    log(f"families: gemma2: text /v1/generate == tokens; logprobs 5 over the prompt truncated "
        f"to {GEMMA_TRUNCATE} ids + {FAMILY_TEXT_NEW}: {secs:.3f} s, flash_attention launches "
        f"+{rose}")
    return stats


def _gemma2_extra(sset, httpd, server, module, cfg, ckpt, device, per_forward, rng):
    """gemma2 past its sliding window, and through the continuous engine:
    a [1, GEMMA_LONG_FORWARD] forward held against the plain attention; a
    GEMMA_LONG_PROMPT decode through the windowed dense cache, each token
    within ``OPTIONS_TIE_TOL`` of a cache-free forward's maximum on its own
    prefix; a ``--continuous-batch`` child and in-process gather and
    in-place paged engines against the plain path."""
    import threading

    import numpy as np
    import torch

    from modelx_tpu_torch.ops import attention as attn

    stats: dict = {}
    port = httpd.server_address[1]
    tokens = torch.randint(0, cfg.vocab_size, (1, GEMMA_LONG_FORWARD), generator=rng).tolist()
    before = attn.flash_attention.launches
    t0 = time.monotonic()
    status, body = _http(port, "/v1/forward", {"tokens": tokens})
    stats["fam_gemma2_long_forward_ms"] = (time.monotonic() - t0) * 1e3
    if status != 200 or attn.flash_attention.launches - before != per_forward:
        raise RuntimeError(f"families: gemma2: /v1/forward [1,{GEMMA_LONG_FORWARD}] answered "
                           f"{status}, {attn.flash_attention.launches - before} launches")
    v = _kernel_vs_plain(server, module, tokens, body["logits_argmax"], "families: gemma2 long")
    log(f"families: gemma2: /v1/forward [1,{GEMMA_LONG_FORWARD}] (window {cfg.sliding_window} "
        f"on the {(cfg.num_layers + 1) // 2} even layers) "
        f"{stats['fam_gemma2_long_forward_ms']:.1f} ms; {v}")

    prompt = torch.randint(0, cfg.vocab_size, (GEMMA_LONG_PROMPT,), generator=rng).tolist()
    status, out = _http(port, "/v1/generate", {"tokens": [prompt],
                                               "max_new_tokens": GEMMA_LONG_NEW})
    if status != 200:
        raise RuntimeError(f"families: gemma2: the long generate answered {status} {out}")
    new = out["tokens"][0][GEMMA_LONG_PROMPT:]

    def prefix_gaps():
        with torch.inference_mode():
            t = torch.tensor([prompt + new[:-1]], device=server.device)
            logits = server.family.forward(server.params, t, server.cfg)[0, len(prompt) - 1:]
            g = torch.tensor(new, device=server.device)
            return (logits.max(-1).values.float()
                    - logits.gather(-1, g[:, None])[:, 0].float()).tolist()

    gaps = _uncounted(prefix_gaps)
    if max(gaps) > OPTIONS_TIE_TOL:
        raise RuntimeError(f"families: gemma2: a token of the {GEMMA_LONG_PROMPT}-token decode "
                           f"lies {max(gaps):.4f} below the cache-free maximum on its prefix")
    log(f"families: gemma2: {GEMMA_LONG_PROMPT}-token prompt + {GEMMA_LONG_NEW} greedy through "
        f"the windowed dense cache: every token within {max(gaps):.4f} of the cache-free "
        f"forward's maximum on its own prefix ({sum(g == 0 for g in gaps)} of "
        f"{len(gaps)} the maximum)")

    # the continuous engine: a serve_main child, then in-process paged engines
    reqs = []
    for i, plen in enumerate(GEMMA_ENGINE_PROMPTS):
        p = torch.randint(0, cfg.vocab_size, (plen,), generator=rng).tolist()
        reqs.append((p, {} if i % 2 == 0 else {"temperature": 0.8, "seed": 200 + i}))
    want = [server.generate(np.asarray([p], np.int32), max_new_tokens=FAMILY_NEW, **s)
            [0, len(p):].tolist() for p, s in reqs]
    httpd.shutdown()  # the child loads its own copy; the in-process server stays
    httpd.server_close()
    child_port = _free_port()
    proc, child_log = _serve_child(ckpt, device, child_port, ckpt, name="gemma2",
                                   slots=GEMMA_ENGINE_SLOTS)
    try:
        answers = [None] * len(reqs)

        def client(i):
            p, samp = reqs[i]
            answers[i] = _post(child_port, "/v1/generate", {"tokens": [p],
                                                            "max_new_tokens": FAMILY_NEW, **samp})

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(len(reqs))]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        stats["fam_gemma2_engine_tps"] = FAMILY_NEW * len(reqs) / (time.monotonic() - t0)
        verdicts = []
        for i, ((p, samp), ans) in enumerate(zip(reqs, answers)):
            if ans is None or ans[0] != 200:
                raise RuntimeError(f"families: gemma2: engine client {i} answered "
                                   f"{ans and ans[:3:2]}")
            got = json.loads(ans[2])["tokens"][0][len(p):]
            verdicts.append(check_near_ties(server, p, got, want[i],
                                            f"families: gemma2 engine client {i}", samp))
        child = _stop_serve_child(proc, child_log, "families: gemma2: the engine child")
        if child != per_forward:
            raise RuntimeError(f"families: gemma2: the engine child launched the kernel {child} "
                               f"times, want its warm-up's {per_forward}")
        proc = None
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    log(f"families: gemma2: serve_main --continuous-batch --max-slots {GEMMA_ENGINE_SLOTS}, "
        f"{len(reqs)} clients (prompts {list(GEMMA_ENGINE_PROMPTS)} + {FAMILY_NEW}, odd ones "
        f"sampled) at once: {stats['fam_gemma2_engine_tps']:.1f} tokens/s; against the plain "
        f"path: {verdicts}")

    outs = {}
    for mode in ("gather", "in-place"):
        cb = _engine(server, max_slots=GEMMA_ENGINE_SLOTS, page_size=GEMMA_PAGE_SIZE,
                     max_live_tokens=GEMMA_ENGINE_SLOTS * CONT_MAX_LEN, paged_attention=mode)
        try:
            before = attn.flash_attention.launches
            outs[mode], secs = _engine_burst(cb, reqs, FAMILY_NEW)
            if attn.flash_attention.launches != before:
                raise RuntimeError(f"families: gemma2: the {mode} engine launched the kernel")
            stats[f"fam_gemma2_tps_{mode}"] = FAMILY_NEW * len(reqs) / secs
        finally:
            _release(cb)
    inplace = ["equal" if a == b else check_near_ties(
                   server, p, a, w, f"families: gemma2 in-place request {i}", s)
               for i, ((p, s), a, b, w) in enumerate(zip(reqs, outs["in-place"], outs["gather"],
                                                         want))]
    log(f"families: gemma2: paged engines ({GEMMA_PAGE_SIZE}-token pages): gather "
        f"{stats['fam_gemma2_tps_gather']:.1f} tokens/s, in place "
        f"{stats['fam_gemma2_tps_in-place']:.1f}; in place against gather: {inplace}")
    return stats, child, None


def _phi3_extra(sset, httpd, server, module, cfg, ckpt, device, per_forward, rng):
    """Phi-3 int8: a ``--quantize int8`` server's /v1/forward runs the kernel
    (head_dim 96) once a layer."""
    import torch

    from modelx_tpu_torch.dl import serve_main
    from modelx_tpu_torch.ops import attention as attn

    if httpd is not None:
        httpd.shutdown()
        httpd.server_close()
        _free(server)
    port = _free_port()
    sset, httpd = serve_main.start([
        "--model", f"phi3={ckpt}", "--listen", f"127.0.0.1:{port}", "--device", device,
        "--dtype", "bfloat16", "--quantize", "int8"])
    q = sset.servers["phi3"]
    tokens = torch.randint(0, cfg.vocab_size, (1, FAMILY_FORWARD_LEN), generator=rng).tolist()
    before = attn.flash_attention.launches
    t0 = time.monotonic()
    status, body = _http(port, "/v1/forward", {"tokens": tokens})
    ms = (time.monotonic() - t0) * 1e3
    rose = attn.flash_attention.launches - before
    if status != 200 or rose != per_forward:
        raise RuntimeError(f"families: phi3 int8: /v1/forward answered {status}, {rose} launches "
                           f"(want {per_forward})")
    _free(q)
    log(f"families: phi3: --quantize int8 ({q.stats['device_bytes'] / 1e9:.3f} GB on the "
        f"device): /v1/forward [1,{FAMILY_FORWARD_LEN}] {ms:.1f} ms, {rose} launches")
    return {"fam_phi3_int8_forward_ms": ms}, 0, httpd


def _gpt2_extra(sset, httpd, server, module, cfg, ckpt, device, per_forward, rng):
    """gpt2's learned positions: a prompt past ``n_positions`` answers the
    JAX sidecar's 400 on /v1/forward, and prompt + max_new_tokens past it on
    /v1/generate."""
    port = httpd.server_address[1]
    n = cfg.n_positions
    checks = (("/v1/forward", {"tokens": [[1] * (n + 1)]},
               f"prompt length {n + 1} exceeds the model's {n}-position context"),
              ("/v1/generate", {"tokens": [[1] * (n - 8)], "max_new_tokens": 16},
               f"prompt ({n - 8}) + max_new_tokens (16) exceeds the model's {n}-position "
               f"context"))
    for path, body, want in checks:
        status, out = _http(port, path, body)
        if status != 400 or out != {"error": want}:
            raise RuntimeError(f"families: gpt2: {path} past n_positions answered {status} {out}")
    log(f"families: gpt2: prompts past n_positions {n} answer 400 on /v1/forward and "
        f"/v1/generate, the JAX sidecar's bodies")
    return {}, 0, httpd


# -- the objectstore path (inside phase 11, on Phi-3-mini) -----------------------------

OBJ_REPO = "library/phi3-mini"
OBJ_GC_REPO = "library/gc-scratch"
OBJ_TOKEN = "smoke-registry-token"  # the registry's accepted bearer token
OBJ_ALIAS = "smoke"
# the served repository's scrub re-hashes this many of its blobs (drawn by
# the registry from seed 0); the small one's scrubs re-hash everything
OBJ_SCRUB_SAMPLE = 1
OBJ_YAML = """description: Phi-3-mini-4k-shaped random weights (chip smoke)
framework: pytorch
task: text-generation
serving:
  model_family: phi3
  dtype: bfloat16
"""
# tests/fake_s3.py's FakeS3 in a child process, unchanged; a subclass of its
# handler appends one JSON line per request to a log (method, object key,
# query keys, Range, body bytes), which the smoke reads to count part PUTs,
# ranged GETs and the bytes the bucket took. It takes a part as the fake's
# PUT does but keeps the part's MD5 (its ETag), so the MD5 is taken once a
# part and a ListParts answers the fake's ETags without hashing every part
# again (7.6 GB of MD5 at the multipart completion)
FAKE_S3_CHILD = r"""
import hashlib, json, os, signal, sys, threading
from urllib.parse import parse_qs, unquote, urlparse
# by path: a host's site-packages may hold another top-level ``tests``
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
from fake_s3 import FakeS3, make_handler

log = open(sys.argv[1], "a", buffering=1)
s3 = FakeS3()
base = make_handler(s3.bucket)
lock = threading.Lock()
md5 = {}


class Logged(base):
    def _note(self):
        u = urlparse(self.path)
        rec = {"m": self.command, "key": unquote(u.path).lstrip("/").split("/", 1)[-1],
               "q": sorted(k for k in parse_qs(u.query, keep_blank_values=True)
                           if not k.startswith("X-Amz-")),
               "range": self.headers.get("Range", ""),
               "bytes": int(self.headers.get("Content-Length", 0) or 0),
               "presigned": "X-Amz-Signature" in u.query}
        with lock:
            log.write(json.dumps(rec) + "\n")

    def do_GET(self):
        self._note()
        base.do_GET(self)

    def do_HEAD(self):
        self._note()
        base.do_GET(self)

    def do_PUT(self):
        self._note()
        q = self._q()
        if "partNumber" not in q or "uploadId" not in q:
            return base.do_PUT(self)
        # a part, as the fake's own PUT takes it, with its one MD5 kept
        if not self._check_presign():
            return self._send(403, b"<Error><Code>AccessDenied</Code></Error>")
        data = self.rfile.read(int(self.headers.get("Content-Length", 0) or 0))
        upload = s3.bucket.uploads.get(q["uploadId"])
        if upload is None or upload["key"] != self._key():
            return self._send(404, b"<Error><Code>NoSuchUpload</Code></Error>")
        n, etag = int(q["partNumber"]), hashlib.md5(data).hexdigest()
        with lock:
            md5[(q["uploadId"], n)] = etag
        with s3.bucket.lock:
            upload["parts"][n] = data
        self._send(200, b"", headers={"ETag": f'"{etag}"'})

    def _list_parts(self, key, upload_id):
        upload = s3.bucket.uploads.get(upload_id)
        if upload is None:
            return base._list_parts(self, key, upload_id)
        with s3.bucket.lock:
            parts = dict(upload["parts"])
        etags = {}
        for n, data in parts.items():
            with lock:
                etags[n] = md5.get((upload_id, n))
            if etags[n] is None:  # a part whose PUT answered just now
                etags[n] = hashlib.md5(data).hexdigest()
        parts = {n: len(data) for n, data in parts.items()}
        body = "<ListPartsResult>" + "".join(
            f'<Part><PartNumber>{n}</PartNumber><ETag>"{etags[n]}"</ETag>'
            f"<Size>{parts[n]}</Size></Part>" for n in sorted(parts)) + "</ListPartsResult>"
        self._send(200, body.encode())

    def do_POST(self):
        self._note()
        base.do_POST(self)

    def do_DELETE(self):
        self._note()
        base.do_DELETE(self)


s3.httpd.RequestHandlerClass = Logged
print(s3.start(), flush=True)
stop = threading.Event()
signal.signal(signal.SIGTERM, lambda *_: stop.set())
while not stop.wait(0.2):
    pass
s3.stop()
"""


def _obj_env(home: str) -> dict:
    env = _child_env()
    env["HOME"] = home  # the CLI's repo aliases (~/.modelx/repos.json) stay in the run's dir
    return env


def _obj_cli(what: str, argv: list, home: str, ok=(0,), timeout: float = 900.0):
    """``modelx-torch ARGV`` as a child process from the checkout: (exit
    code, stdout, seconds); an exit code outside ``ok`` fails the path."""
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", "modelx_tpu_torch.cli", *argv], cwd=REPO,
                          env=_obj_env(home), capture_output=True, text=True, timeout=timeout)
    secs = time.monotonic() - t0
    if proc.returncode not in ok:
        raise RuntimeError(f"objectstore: {what}: modelx-torch {' '.join(argv)} exited "
                           f"{proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return proc.returncode, proc.stdout, secs


def _obj_start(what: str, argv: list, log_path: str, home: str):
    """A long-running child (output to ``log_path``)."""
    log_f = open(log_path, "w")
    proc = subprocess.Popen(argv, cwd=REPO, env=_obj_env(home), stdout=log_f,
                            stderr=subprocess.STDOUT)
    log_f.close()
    return proc


def _obj_stop(proc) -> None:
    if proc is not None and proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)


def _obj_request(base: str, path: str, token: str = "") -> tuple[int, bytes]:
    import urllib.error
    import urllib.request

    headers = {"Authorization": f"Bearer {token}"} if token else {}
    req = urllib.request.Request(base + path, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _obj_counter(base: str, name: str) -> float:
    """One counter of the registry's /metrics (Prometheus text)."""
    status, body = _obj_request(base, "/metrics", OBJ_TOKEN)
    if status != 200:
        raise RuntimeError(f"objectstore: /metrics answered {status}")
    for line in body.decode().splitlines():
        key, _, value = line.rpartition(" ")
        if key == f"modelx_{name}":
            return float(value)
    return 0.0


def _obj_requests(log_path: str, key: str) -> list:
    with open(log_path) as f:
        return [r for r in map(json.loads, f) if r["key"] == key]


def phase_objectstore(ckpt: str, device: str, tokens: list, want_argmax: list,
                      per_forward: int) -> dict:
    """Load separation on Phi-3-mini (module docstring, phase 11), run on
    phi3's checkpoint once the families phase has served it: the native
    engine hashes the weights (the digest before the push); the port's
    registry (``modelxd-torch --s3-url --enable-redirect --auth-token``)
    runs over tests/fake_s3.py's bucket, each in a child process, and a
    request without the token answers 401; ``modelx-torch login`` and
    ``push`` move the checkpoint into the bucket through presigned uploads
    (multipart above 64 MiB), none of its bytes through the registry, and
    the manifest carries the digest taken before the push. The source is
    deleted and ``modelxdl-torch --device-put`` pulls it back through
    presigned ranged GETs onto the device (tensors == the pulled file,
    native reads counted); hashlib hashes every pulled file to its
    descriptor's digest. A small second repository takes ``modelx-torch
    gc`` (an orphan goes, referenced blobs stay) and a full ``scrub`` (a
    corrupted object reported and quarantined); the served repository
    takes a sampled scrub. ``serve_main`` on the pulled copy answers the
    pre-push forward's argmax exactly with ``per_forward`` launches. Its
    flash launches are counted from 0. The pulled copy is left at
    ``ckpt + "-pulled"`` for the caller, and deleted on a failure."""
    import hashlib
    import shutil
    import tempfile

    import numpy as np

    from modelx_tpu_torch import native
    from modelx_tpu_torch.client.client import Client
    from modelx_tpu_torch.dl import serve_main
    from modelx_tpu_torch.ops import attention as attn
    from modelx_tpu_torch.registry.fs_s3 import S3Client, S3Options
    from modelx_tpu_torch.registry.store_s3 import MULTIPART_THRESHOLD, plan_parts
    from modelx_tpu_torch.types import Descriptor, Digest

    stats: dict = {}
    attn.flash_attention.launches = 0  # the objectstore path's own count
    t_path = time.monotonic()
    root = tempfile.mkdtemp(prefix="modelx-objectstore-")
    home = os.path.join(root, "home")
    os.makedirs(home, exist_ok=True)
    weights = os.path.join(ckpt, "model.safetensors")
    nbytes = os.path.getsize(weights)
    pulled = ckpt + "-pulled"
    s3_proc = reg_proc = None
    ok = False
    try:
        # (1) the native engine (built at phase 2, or here when the path
        # runs alone), and the one that hashes
        t0 = time.monotonic()
        built = native.build()
        stats["obj_native_build_s"] = time.monotonic() - t0
        if not native.available():
            if shutil.which("g++"):
                raise RuntimeError("objectstore: the native engine is unavailable while g++ is "
                                   "on PATH (no hidden fallback)")
            log("objectstore: no g++ in reach: the native engine degrades to the Python paths")

        # (2) the bucket and the registry start while the weights hash
        s3_log, reg_log = os.path.join(root, "s3.jsonl"), os.path.join(root, "registry.log")
        s3_proc = _obj_start("fake S3", [sys.executable, "-u", "-c", FAKE_S3_CHILD, s3_log],
                             os.path.join(root, "s3.out"), home)
        t0 = time.monotonic()
        native_digest = str(Digest.from_file(weights))
        stats["obj_hash_native_gbps"] = nbytes / max(time.monotonic() - t0, 1e-9) / 1e9
        log(f"objectstore: native engine {'ready' if built else 'absent'} in "
            f"{stats['obj_native_build_s']:.1f} s; Digest.from_file hashed {nbytes / 1e9:.3f} GB "
            f"at {stats['obj_hash_native_gbps']:.2f} GB/s (the digest before the push)")
        deadline = time.monotonic() + 60
        s3_url = ""
        while not s3_url and time.monotonic() < deadline:
            if s3_proc.poll() is not None:
                raise RuntimeError(f"objectstore: the fake S3 exited {s3_proc.returncode}: "
                                   f"{open(os.path.join(root, 's3.out')).read()[-2000:]}")
            with open(os.path.join(root, "s3.out")) as f:
                s3_url = f.readline().strip()
            time.sleep(0.1)
        port = _free_port()
        base = f"http://127.0.0.1:{port}"
        reg_proc = _obj_start("registry", [
            sys.executable, "-m", "modelx_tpu_torch.registry.server_main", "--listen",
            f"127.0.0.1:{port}", "--s3-url", s3_url, "--s3-access-key", "smoke-ak",
            "--s3-secret-key", "smoke-sk", "--s3-bucket", "models", "--enable-redirect",
            "--auth-token", OBJ_TOKEN], reg_log, home)
        while time.monotonic() < deadline + 60:
            if reg_proc.poll() is not None:
                raise RuntimeError(f"objectstore: the registry exited {reg_proc.returncode}: "
                                   f"{open(reg_log).read()[-3000:]}")
            try:
                if _obj_request(base, "/healthz")[0] == 200:
                    break
            except OSError:
                pass
            time.sleep(0.2)
        else:
            raise RuntimeError("objectstore: the registry did not answer /healthz")
        no_token, with_token = _obj_request(base, "/")[0], _obj_request(base, "/", OBJ_TOKEN)[0]
        if (no_token, with_token) != (401, 200):
            raise RuntimeError(f"objectstore: GET / answered {no_token} without the token and "
                               f"{with_token} with it, want 401 and 200")

        # (3) push with the CLI
        with open(os.path.join(ckpt, "modelx.yaml"), "w") as f:
            f.write(OBJ_YAML)
        _obj_cli("login", ["login", base, "--token", OBJ_TOKEN, "--name", OBJ_ALIAS], home)
        ref = f"{OBJ_ALIAS}/{OBJ_REPO}@v1"
        _, out, push_s = _obj_cli("push", ["push", ref, ckpt], home)
        stats["obj_push_s"] = push_s
        stats["obj_push_gbps"] = nbytes / push_s / 1e9
        parts = plan_parts(nbytes) if nbytes > MULTIPART_THRESHOLD else [(0, nbytes)]
        stats["obj_parts"] = len(parts)
        stats["obj_presign_issued"] = _obj_counter(base, "presign_issued_total")
        manifest = Client(base, "Bearer " + OBJ_TOKEN).get_manifest(OBJ_REPO, "v1")
        pushed = next(d.digest for d in manifest.blobs if d.name == "model.safetensors")
        if pushed != native_digest:
            raise RuntimeError(f"objectstore: the manifest carries {pushed} for the weights, the "
                               f"digest before the push was {native_digest}")
        key = f"registry/{OBJ_REPO}/blobs/sha256/{native_digest.split(':')[1]}"
        reqs = _obj_requests(s3_log, key)
        part_puts = [r for r in reqs if r["m"] == "PUT" and r["presigned"]
                     and "partNumber" in r["q"]]
        single_puts = [r for r in reqs if r["m"] == "PUT" and r["presigned"]
                       and "partNumber" not in r["q"]]
        got_parts = len(part_puts) if len(parts) > 1 else len(single_puts)
        put_bytes = sum(r["bytes"] for r in part_puts + single_puts)
        if got_parts != len(parts) or put_bytes != nbytes:
            raise RuntimeError(f"objectstore: the bucket took {got_parts} presigned PUTs of "
                               f"{put_bytes} bytes for the weights, want {len(parts)} of {nbytes}")
        s3c = S3Client(S3Options(url=s3_url, access_key="smoke-ak", secret_key="smoke-sk",
                                 bucket="models"))
        sizes = {o.name: o.size for o in s3c.list_objects("registry/")[0]}
        if sizes.get(key) != nbytes:
            raise RuntimeError(f"objectstore: the bucket holds {sizes.get(key)} bytes at {key}, "
                               f"want {nbytes}")
        blob_routes = [ln for ln in open(reg_log) if f"/blobs/{native_digest}" in ln
                       and "/locations/" not in ln and (" GET " in ln or " PUT " in ln)]
        if blob_routes:
            raise RuntimeError(f"objectstore: the registry answered blob-content routes for the "
                               f"weights: {blob_routes[:3]}")
        log(f"objectstore: modelx-torch push of {nbytes / 1e9:.3f} GB in {push_s:.1f} s "
            f"({stats['obj_push_gbps']:.2f} GB/s, client to bucket): {len(parts)} presigned "
            f"part{'s' if len(parts) > 1 else ''}, {int(stats['obj_presign_issued'])} locations "
            f"issued; the manifest carries the digest before the push; the bucket took every "
            f"byte, the registry served none of them; no token 401, token 200")

        # (4) pull onto the device, the source deleted first
        shutil.rmtree(ckpt, ignore_errors=True)
        t0 = time.monotonic()
        summary = _run_child("modelxdl-torch", [
            sys.executable, "-c", DL_CHILD, f"{base}/{OBJ_REPO}@v1?token={OBJ_TOKEN}", pulled,
            "--device-put", "--device", device], timeout=900)
        stats["obj_pull_s"] = time.monotonic() - t0
        load = summary["load"]
        stats["obj_pull_gbps"] = nbytes / max(summary["pull_seconds"], 1e-9) / 1e9
        stats["obj_load_gbps"] = load["gbps"]
        stats["obj_native_reads"] = load["native_reads"]
        tc = summary["tensor_check"]
        if tc["mismatched"] or tc["not_in_dest"] or not tc["tensors"]:
            raise RuntimeError(f"objectstore: tensors on the device differ from the pulled file: "
                               f"{tc}")
        if native.available() and not load["native_reads"]:
            raise RuntimeError("objectstore: the load's native read count stayed 0 on an http "
                               "source (no hidden fallback)")
        ranged = [r for r in _obj_requests(s3_log, key) if r["m"] == "GET" and r["range"]]
        stats["obj_ranged_gets"] = len(ranged)
        log(f"objectstore: modelxdl-torch --device-put: pull {summary['pull_seconds']} s "
            f"({stats['obj_pull_gbps']:.2f} GB/s bucket to disk), load {load['seconds']} s "
            f"({load['gbps']} GB/s bucket to {device}, transports {load['transports']}), "
            f"{len(ranged)} presigned ranged GETs of the weights, {load['native_reads']} of the "
            f"loader's reads through the native engine; {tc['tensors']} tensors == the pulled "
            f"file")
        # hashlib, the engine's cross-check: every pulled file hashes to its
        # descriptor's digest, the weights to the native digest before the push
        for desc in manifest.all_descriptors():
            path = os.path.join(pulled, desc.name)
            if not os.path.isfile(path):
                continue
            t0 = time.monotonic()
            h = hashlib.sha256()
            with open(path, "rb") as f:
                while chunk := f.read(4 << 20):
                    h.update(chunk)
            if "sha256:" + h.hexdigest() != desc.digest:
                raise RuntimeError(f"objectstore: pulled {desc.name} does not hash to its "
                                   f"descriptor's digest")
            if desc.name == "model.safetensors":
                stats["obj_hash_hashlib_gbps"] = nbytes / max(time.monotonic() - t0, 1e-9) / 1e9
        log(f"objectstore: hashlib hashed the pulled weights at "
            f"{stats['obj_hash_hashlib_gbps']:.2f} GB/s to the native digest before the push; "
            f"every pulled file == its descriptor's digest")

        # (5) gc and scrub: a small second repository takes both in full;
        # the served one a sampled scrub
        small = os.path.join(root, "small")
        os.makedirs(small, exist_ok=True)
        with open(os.path.join(small, "modelx.yaml"), "w") as f:
            f.write("description: gc and scrub scratch\n")
        rng = np.random.RandomState(5)
        with open(os.path.join(small, "weights.bin"), "wb") as f:
            f.write(rng.bytes(1 << 20))
        gc_ref = f"{OBJ_ALIAS}/{OBJ_GC_REPO}@v1"
        _obj_cli("push small", ["push", gc_ref, small], home)
        orphan = rng.bytes(4096)
        orphan_digest = str(Digest.from_bytes(orphan))
        Client(base, "Bearer " + OBJ_TOKEN).remote.upload_blob_content(
            OBJ_GC_REPO, Descriptor(name="orphan", digest=orphan_digest, size=len(orphan)),
            orphan)
        _, out, _ = _obj_cli("gc", ["gc", f"{OBJ_ALIAS}/{OBJ_GC_REPO}", "--grace", "0"], home)
        gc_out = json.loads(out.strip().splitlines()[-1])
        remote = Client(base, "Bearer " + OBJ_TOKEN).remote
        kept = [d.digest for d in remote.get_manifest(OBJ_GC_REPO, "v1").all_descriptors()]
        if (gc_out["deleted_digests"] != [orphan_digest]
                or remote.head_blob(OBJ_GC_REPO, orphan_digest)
                or not all(remote.head_blob(OBJ_GC_REPO, d) for d in kept)):
            raise RuntimeError(f"objectstore: gc deleted {gc_out['deleted_digests']}, want only "
                               f"the orphan {orphan_digest}, every referenced blob kept")
        _, out, _ = _obj_cli("scrub", ["scrub", f"{OBJ_ALIAS}/{OBJ_GC_REPO}"], home)
        small_clean = json.loads(out.strip().splitlines()[-1])
        if not small_clean["clean"] or small_clean["checked"] != len(kept):
            raise RuntimeError(f"objectstore: scrub of {OBJ_GC_REPO} before the damage: "
                               f"{small_clean}")
        t0 = time.monotonic()
        _, out, _ = _obj_cli("scrub", ["scrub", f"{OBJ_ALIAS}/{OBJ_REPO}", "--sample",
                                       str(OBJ_SCRUB_SAMPLE)], home)
        stats["obj_scrub_s"] = time.monotonic() - t0
        clean = json.loads(out.strip().splitlines()[-1])
        if not clean["clean"] or clean["checked"] != OBJ_SCRUB_SAMPLE:
            raise RuntimeError(f"objectstore: sampled scrub of the served repository: {clean}")
        victim = next(d.digest for d in remote.get_manifest(OBJ_GC_REPO, "v1").blobs
                      if d.name == "weights.bin")
        s3c.put_object(f"registry/{OBJ_GC_REPO}/blobs/sha256/{victim.split(':')[1]}",
                       b"corrupted in the bucket")
        rc, out, _ = _obj_cli("scrub corrupt", ["scrub", f"{OBJ_ALIAS}/{OBJ_GC_REPO}"], home,
                              ok=(1,))
        dirty = json.loads(out.strip().splitlines()[-1])
        if dirty["quarantined"] != [victim] or dirty["clean"]:
            raise RuntimeError(f"objectstore: scrub after corrupting {victim}: {dirty}")
        log(f"objectstore: gc --grace 0 removed the orphan and kept the {len(kept)} referenced "
            f"blobs; scrub of {OBJ_GC_REPO} clean ({small_clean['checked']} blobs re-hashed), "
            f"then a corrupted object of it quarantined, exit {rc}; scrub --sample "
            f"{OBJ_SCRUB_SAMPLE} of {OBJ_REPO} clean ({clean['bytes_hashed'] / 1e9:.3f} GB "
            f"re-hashed in {stats['obj_scrub_s']:.1f} s)")
        _obj_stop(reg_proc)
        _obj_stop(s3_proc)
        reg_proc = s3_proc = None

        # (6) serve what was pulled: the same bytes and kernel as the
        # pre-push forward, so the same argmax exactly
        port2 = _free_port()
        sset, httpd = serve_main.start([
            "--model", f"phi3={pulled}", "--listen", f"127.0.0.1:{port2}", "--device", device,
            "--dtype", "bfloat16"])
        server = sset.servers["phi3"]
        try:
            before = attn.flash_attention.launches
            t0 = time.monotonic()
            status, body = _http(port2, "/v1/forward", {"tokens": tokens})
            stats["obj_forward_ms"] = (time.monotonic() - t0) * 1e3
            launched = attn.flash_attention.launches - before
            if status != 200 or np.asarray(body["logits_argmax"]).shape != (1, len(tokens[0])):
                raise RuntimeError(f"objectstore: /v1/forward on the pulled copy answered "
                                   f"{status} {str(body)[:300]}")
            if launched != per_forward:
                raise RuntimeError(f"objectstore: the forward launched the kernel {launched} "
                                   f"times, want {per_forward}")
            if body["logits_argmax"] != want_argmax:
                bad = sum(a != b for a, b in zip(body["logits_argmax"][0], want_argmax[0]))
                raise RuntimeError(f"objectstore: the pulled copy's argmax differs from the "
                                   f"pre-push forward's at {bad} positions (same bytes, same "
                                   f"kernel)")
        finally:
            httpd.shutdown()
            httpd.server_close()
            _free(server)
        stats["flash_launches_objectstore"] = attn.flash_attention.launches
        stats["obj_disk_bytes"] = sum(os.path.getsize(os.path.join(d, f))
                                      for d, _, fs in os.walk(pulled) for f in fs)
        stats["obj_path_s"] = time.monotonic() - t_path
        log(f"objectstore: serve_main on the pulled copy: /v1/forward [1,{len(tokens[0])}] "
            f"{stats['obj_forward_ms']:.1f} ms, {launched} launches, equal to the pre-push "
            f"forward's argmax")
        log(f"objectstore: the path took {stats['obj_path_s']:.1f} s and wrote "
            f"{stats['obj_disk_bytes'] / 1e9:.3f} GB to disk (the pulled copy; the source went "
            f"first); flash_attention launches {stats['flash_launches_objectstore']}")
        ok = True
        return stats
    finally:
        _obj_stop(reg_proc)
        _obj_stop(s3_proc)
        shutil.rmtree(root, ignore_errors=True)
        if not ok:
            shutil.rmtree(pulled, ignore_errors=True)



# -- phase 12: training on one card ------------------------------------------------

# Llama-3-8B's widths at 2 of its 32 layers: at full depth the params, grads
# and two bf16 moments alone are 4 x 16.06 GB = 64.2 GB, and the activations
# and fp32 logits pass the card's 80 GB
TRAIN_LAYERS = 2
TRAIN_SEQ = 2048
TRAIN_STEPS = 8
TRAIN_LR = 3e-4  # modelx-train's default
# each parameter's gradient, flash path (the kernels) against the plain path
# (attention_reference under autograd), bf16 end to end: relative L2 gap
# ||g_flash - g_plain|| / ||g_plain||. The two attentions round P and O to
# bf16 at other places (~2^-8 relative); a cut graph leaves a grad None and
# a wrong dS, softcap factor or GQA sum moves a tensor's gradient by O(1)
TRAIN_GRAD_TOL = 0.05
# the same step's loss, flash path against plain path, relative: a mean of
# fp32 log-softmax NLLs over the batch's tokens, whose logits differ only by
# the two attentions' bf16 rounding (~2^-8 relative per entry, averaged down)
TRAIN_LOSS_TOL = 1e-3
# the tiny entry-point runs (c): LlamaConfig.tiny (head_dim 32), bf16
TINY_BATCH = 2
TINY_SEQ = 128
TINY_STEPS = (4, 2, 1)  # train, resume and push v1, one more step and push v2

TRAIN_CHILD = r"""
import sys
import torch
from modelx_tpu_torch.models import train_main
from modelx_tpu_torch.ops import attention as attn
rc = train_main.main(sys.argv[1:])
peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
print("TRAIN_LAUNCHES", attn.flash_attention.launches, attn.flash_attention_backward.launches,
      peak, flush=True)
sys.exit(rc)
"""
_STEP_LOSS = re.compile(r"step (\d+)\s+loss ([-+0-9.einfa]+)")


def check_train_launches(what: str, fwd: int, bwd: int, want: int) -> None:
    """Both kernels launched ``want`` times (one per layer per step), or fail."""
    if fwd != want:
        raise RuntimeError(f"train: {what}: flash_attention launched {fwd} times, want {want}")
    if bwd != want:
        raise RuntimeError(f"train: {what}: flash_attention_backward launched {bwd} times, "
                           f"want {want}")


def check_train_loss(flash: float, plain: float, tol: float) -> float:
    """The flash path's loss within ``tol`` relative of the plain path's,
    or fail; returns the gap."""
    gap = abs(flash - plain) / abs(plain)
    if not gap <= tol:
        raise RuntimeError(f"train: the loss through the kernels {flash} is {gap:.3e} relative "
                           f"from the plain attention's {plain} (tol {tol})")
    return gap


def check_grads(flash: dict, plain: dict, tol: float) -> tuple[float, str]:
    """Every parameter has a gradient on both paths, each within ``tol``
    relative L2 of the plain path's; returns the worst gap and its name."""
    missing = sorted(n for n in plain if flash.get(n) is None or plain[n] is None)
    if missing:
        raise RuntimeError(f"train: no gradient reached {missing[:4]} "
                           f"({len(missing)} of {len(plain)} params): a cut graph")
    worst, worst_name = 0.0, ""
    for name, want in plain.items():
        ref = want.float()
        gap = float((flash[name].float() - ref).norm() / ref.norm().clamp_min(1e-30))
        if not math.isfinite(gap) or gap > worst:
            worst, worst_name = gap, name
    if not worst <= tol:
        raise RuntimeError(f"train: {worst_name}'s gradient is {worst:.4f} (relative L2) from "
                           f"the plain path's, past {tol}")
    return worst, worst_name


def _train_child(what: str, args: list, timeout: float = 900.0) -> dict:
    """``modelx-train-torch`` with ``args`` as a child from the checkout;
    its summary, per-step losses, kernel launches and peak device memory."""
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", TRAIN_CHILD, *args], cwd=REPO,
                          env=_child_env(), capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"train: {what}: modelx-train-torch exited {proc.returncode}\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    lines = proc.stdout.strip().splitlines()
    _, fwd, bwd, peak = lines[-1].split()
    out = {"summary": json.loads(lines[-2]), "fwd": int(fwd), "bwd": int(bwd),
           "peak_gb": int(peak) / 1e9, "seconds": time.monotonic() - t0,
           "losses": [float(m.group(2)) for m in _STEP_LOSS.finditer(proc.stderr)]}
    log(f"train: {what}: {out['summary']} in {out['seconds']:.1f} s (process); losses "
        f"{[round(x, 4) for x in out['losses']]}; launches forward {out['fwd']}, backward "
        f"{out['bwd']}; peak {out['peak_gb']:.3f} GB")
    return out


def _train_in_process(what: str, args: list) -> dict:
    """``modelx-train-torch``'s ``run`` with ``args`` in this process (a
    child's start costs ~10 s on the card's machine): the summary its last
    line prints, the per-step losses of its log, the kernel launches
    counted from 0 and the peak device memory, as ``_train_child`` reads
    them off a child."""
    import logging

    import torch

    from modelx_tpu_torch.models import train_main
    from modelx_tpu_torch.ops import attention as attn

    messages: list[str] = []

    class Collect(logging.Handler):
        def emit(self, record):
            messages.append(record.getMessage())

    handler, logger = Collect(level=logging.INFO), logging.getLogger("modelx.train")
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    on_card = torch.cuda.is_available()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    attn.flash_attention.launches = attn.flash_attention_backward.launches = 0
    t0 = time.monotonic()
    try:
        summary = train_main.run(args)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    out = {"summary": summary, "fwd": attn.flash_attention.launches,
           "bwd": attn.flash_attention_backward.launches,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0,
           "seconds": time.monotonic() - t0,
           "losses": [float(m.group(2)) for m in _STEP_LOSS.finditer("\n".join(messages))]}
    log(f"train: {what}: {out['summary']} in {out['seconds']:.1f} s (in process); losses "
        f"{[round(x, 4) for x in out['losses']]}; launches forward {out['fwd']}, backward "
        f"{out['bwd']}; peak {out['peak_gb']:.3f} GB")
    return out


def _blob_puts(base: str) -> float:
    port = int(base.rsplit(":", 1)[1])
    _, _, raw = _http_raw(port, "/metrics?format=prometheus")
    for line in raw.decode().splitlines():
        if line.startswith("modelx_blob_put_total "):
            return float(line.split()[1])
    return 0.0


def _digests(directory: str) -> dict:
    import hashlib

    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def _tree_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)


def phase_train(device: str = "cuda", cfg=None, tiny_cfg=None) -> dict:
    """Training on one card (module docstring, phase 12): (a) Llama-3-8B's
    widths at ``TRAIN_LAYERS`` layers through ``modelx-train-torch`` on a
    repeated batch (the loss falls; both kernels once per layer per step);
    (b) in process, one step's gradients through the kernels against the
    plain attention's (none None, each within ``TRAIN_GRAD_TOL``; the loss
    within ``TRAIN_LOSS_TOL``); (c) the
    entry point at ``--config tiny`` (head_dim 32): train, resume, push to
    a ``modelxd-torch`` and push again after one more step (only changed
    shards upload), then push the unchanged checkpoint in process (nothing
    uploads).
    Its launches are counted from 0 (in the children, and in process)."""
    import dataclasses
    import gc
    import shutil

    import numpy as np
    import torch

    from modelx_tpu_torch.dl import families as fam
    from modelx_tpu_torch.dl import safetensors as st
    from modelx_tpu_torch.dl.loader import LocalFileSource, load_safetensors
    from modelx_tpu_torch.models import llama
    from modelx_tpu_torch.models import train as train_mod
    from modelx_tpu_torch.ops import attention as attn

    on_card = device == "cuda"
    cfg = cfg or dataclasses.replace(llama.LlamaConfig.llama3_8b(), num_layers=TRAIN_LAYERS)
    tiny_cfg = tiny_cfg or llama.LlamaConfig.tiny()
    dev_args = [] if on_card else ["--device", "cpu"]
    t_phase = time.monotonic()
    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    nbytes = 2 * sum(math.prod(x) for x in llama.param_shapes(cfg).values())
    root = _checkpoint_dir(nbytes)
    stats: dict = {"train_fwd_launches": 0, "train_bwd_launches": 0}
    reg = None
    try:
        # (a) the full-width cut through the entry point
        model_dir = os.path.join(root, "model")
        os.makedirs(model_dir)
        t0 = time.monotonic()
        params = llama.init_params(cfg, torch.Generator(device=device).manual_seed(14),
                                   dtype=torch.bfloat16)
        st.write_safetensors(os.path.join(model_dir, "model.safetensors"), params)
        del params
        stats["train_write_s"] = time.monotonic() - t0
        data = os.path.join(root, "tokens.npy")
        np.save(data, np.random.RandomState(14).randint(
            0, cfg.vocab_size, TRAIN_SEQ + 1).astype(np.int32))  # one window: every step's batch
        log(f"train: wrote {nbytes / 1e9:.3f} GB ({cfg}) in {stats['train_write_s']:.1f} s")
        run = _train_child(f"{cfg.num_layers} layers at Llama-3-8B's widths", [
            "--model-dir", model_dir, "--data", data, "--batch", "1", "--seq", str(TRAIN_SEQ),
            "--steps", str(TRAIN_STEPS), "--lr", str(TRAIN_LR), "--log-every", "1", *dev_args])
        losses = run["losses"]
        if run["summary"]["steps"] != TRAIN_STEPS or len(losses) != TRAIN_STEPS:
            raise RuntimeError(f"train: want {TRAIN_STEPS} steps and losses, got "
                               f"{run['summary']} and {losses}")
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            raise RuntimeError(f"train: the loss did not fall on a repeated batch: {losses}")
        per_step = cfg.num_layers if on_card else 0
        check_train_launches("the full-width run", run["fwd"], run["bwd"], per_step * TRAIN_STEPS)
        stats.update({"train_losses": losses, "train_tokens_per_s": run["summary"]["tokens_per_s"],
                      "train_child_s": run["seconds"], "train_child_peak_gb": run["peak_gb"]})
        stats["train_fwd_launches"] += run["fwd"]
        stats["train_bwd_launches"] += run["bwd"]

        # (b) one step's gradients: the kernels against the plain attention
        infos, off = st.read_header_from_file(os.path.join(model_dir, "model.safetensors"))
        inferred = fam.infer_llama_config(fam.abstract_params(infos))
        src = LocalFileSource(os.path.join(model_dir, "model.safetensors"))
        try:
            params, _ = load_safetensors(src, device, tensors=infos, data_offset=off)
        finally:
            src.close()
        window = torch.from_numpy(np.load(data)).to(device)[None]
        batch = {"tokens": window[:, :-1], "targets": window[:, 1:]}

        def forward(impl):
            return lambda p, t: llama.forward(p, t, inferred, attention_impl=impl)[0]

        attn.flash_attention.launches = attn.flash_attention_backward.launches = 0
        t0 = time.monotonic()
        loss_k, grads_k = train_mod.loss_and_grads(params, batch, forward("auto"))
        if on_card:
            torch.cuda.synchronize()
        stats["train_grad_s"] = time.monotonic() - t0
        fwd, bwd = attn.flash_attention.launches, attn.flash_attention_backward.launches
        check_train_launches("the gradient check", fwd, bwd, per_step)
        stats["train_fwd_launches"] += fwd
        stats["train_bwd_launches"] += bwd
        loss_p, grads_p = train_mod.loss_and_grads(params, batch, forward("reference"))
        worst, name = check_grads(grads_k, grads_p, TRAIN_GRAD_TOL)
        loss_gap = check_train_loss(float(loss_k), float(loss_p), TRAIN_LOSS_TOL)
        stats.update({"train_grad_gap": worst, "train_grad_gap_param": name,
                      "train_loss_kernel": float(loss_k), "train_loss_plain": float(loss_p),
                      "train_loss_gap": loss_gap})
        log(f"train: gradients of {len(grads_p)} params, kernels vs plain attention: every "
            f"one present, worst relative L2 gap {worst:.5f} ({name}; tol {TRAIN_GRAD_TOL}); "
            f"loss {float(loss_k):.5f} vs {float(loss_p):.5f} ({loss_gap:.2e} relative; tol "
            f"{TRAIN_LOSS_TOL}); the kernel path's forward and "
            f"backward {stats['train_grad_s']:.2f} s")
        del params, grads_k, grads_p, batch, window
        gc.collect()
        if on_card:
            stats["train_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            torch.cuda.empty_cache()

        # (c) the tiny config through the entry point: resume and push
        reg, base = _start_registry(os.path.join(root, "registry"),
                                    os.path.join(root, "registry.log"))
        ck = os.path.join(root, "tiny-ck")
        tiny_data = os.path.join(root, "tiny.npy")
        np.save(tiny_data, np.random.RandomState(15).randint(
            1, tiny_cfg.vocab_size, 8 * TINY_BATCH * (TINY_SEQ + 1)).astype(np.int32))
        common = ["--config", "tiny", "--data", tiny_data, "--batch", str(TINY_BATCH),
                  "--seq", str(TINY_SEQ), "--checkpoint-dir", ck, "--log-every", "1", *dev_args]
        tiny_per_step = tiny_cfg.num_layers if on_card else 0
        first, resumed, more = TINY_STEPS
        # in process: the entry point's run, as its main calls it
        runs = [_train_in_process("tiny, fresh", [*common, "--steps", str(first)])]
        runs.append(_train_in_process("tiny, resumed and pushed", [
            *common, "--steps", str(resumed), "--push", f"{base}/library/tiny-train@v1"]))
        if runs[1]["summary"]["steps"] != first + resumed:
            raise RuntimeError(f"train: the resumed run reads {runs[1]['summary']['steps']} "
                               f"steps, want {first + resumed}")
        puts_v1 = _blob_puts(base)
        before = _digests(ck)
        runs.append(_train_in_process("tiny, one more step and pushed", [
            *common, "--steps", str(more), "--push", f"{base}/library/tiny-train@v2"]))
        changed = sum(1 for n, h in _digests(ck).items() if before.get(n) != h)
        puts_v2 = _blob_puts(base)
        # the unchanged checkpoint again, through the checkpointer the entry
        # point pushes with
        from modelx_tpu_torch.dl.checkpoint import Checkpointer

        Checkpointer(ck).push(f"{base}/library/tiny-train@v3")
        puts_v3 = _blob_puts(base)
        if runs[2]["summary"]["steps"] != first + resumed + more:
            raise RuntimeError(f"train: the third run reads {runs[2]['summary']['steps']} steps")
        if puts_v2 - puts_v1 != changed or puts_v3 != puts_v2:
            raise RuntimeError(f"train: pushes uploaded {puts_v1} blobs, then {puts_v2 - puts_v1} "
                               f"with {changed} files changed, then {puts_v3 - puts_v2} with "
                               f"none changed")
        for r, steps in zip(runs, TINY_STEPS):
            check_train_launches("the tiny entry-point run", r["fwd"], r["bwd"],
                                 tiny_per_step * steps)
            stats["train_fwd_launches"] += r["fwd"]
            stats["train_bwd_launches"] += r["bwd"]
        stats.update({"train_tiny_steps": runs[2]["summary"]["steps"],
                      "train_push_blobs": [puts_v1, puts_v2 - puts_v1, puts_v3 - puts_v2],
                      "train_push_changed": changed})
        log(f"train: tiny entry point: {first} steps, resumed to {first + resumed}, pushed "
            f"{puts_v1:.0f} blobs; one more step changed {changed} of {len(before)} files and "
            f"uploaded {puts_v2 - puts_v1:.0f}; the unchanged checkpoint uploaded "
            f"{puts_v3 - puts_v2:.0f}")
        stats["train_bytes_written"] = _tree_bytes(root)
    finally:
        if reg is not None:
            reg.terminate()
            try:
                reg.wait(timeout=30)
            except subprocess.TimeoutExpired:
                reg.kill()
                reg.wait()
        shutil.rmtree(root, ignore_errors=True)
    stats["train_phase_s"] = time.monotonic() - t_phase
    log(f"train: the phase took {stats['train_phase_s']:.1f} s, wrote "
        f"{stats['train_bytes_written'] / 1e9:.3f} GB of files (deleted), peak "
        f"torch.cuda.max_memory_allocated {stats.get('train_peak_gb', 0.0):.3f} GB in process, "
        f"{stats['train_child_peak_gb']:.3f} GB in the full-width child; launches forward "
        f"{stats['train_fwd_launches']}, backward {stats['train_bwd_launches']}")
    return stats


# -- phase 14: the mesh ------------------------------------------------------------------

# the mesh phase's checkpoint: Llama-3-8B's widths at 2 of 32 layers (the
# train phase's cut, 2.97 GB)
MESH_LAYERS = 2
MESH_FORWARD = (1, 2048)
MESH_PROMPT, MESH_NEW_TOKENS = 128, 32
# (a): one rank over NCCL, through ``modelx-serve-torch --mesh``: the axes
# dp, tp and sp at size 1, with the automatic attention (the flash kernel)
# and the two sequence-parallel ones
MESH_A_RUNS = (("dp=1,tp=1", "auto"), ("sp=1", "ulysses"), ("sp=1", "ring"))
# (b): two ranks on the one card over gloo (NCCL refuses two ranks on one
# device): tensor parallel and Ulysses (and the ring, where gloo takes
# CUDA tensors for point-to-point), each forward's logits against the
# meshless forward's; which collectives each needs
MESH_B_SEQ = 512
MESH_B_RUNS = (("tp=2", "auto", ("all_reduce", "all_gather", "broadcast")),
               ("sp=2", "ulysses", ("all_to_all_single", "all_gather", "broadcast")),
               ("sp=2", "ring", ("batch_isend_irecv", "all_gather", "broadcast")))
# bf16 logits of each mesh forward against the meshless forward's, by run.
# tp=2: the row-parallel sums round each rank's partial product to bf16
# before they add; twice the 0.0625 read on an H100 at 700 W (PERF.md §6).
# Ulysses: heads are whole on each rank and the flash kernel computes each
# head alone, so the logits are equal bit for bit (read 0.0 there). The
# ring merges its hops in plain torch in fp32: held as tp=2 (gloo refuses
# its point-to-point of CUDA tensors, so it is checked on the CPU only).
MESH_B_TOL = {"tp=2 auto": 0.125, "sp=2 ulysses": 0.0, "sp=2 ring": 0.125}
# the collectives gloo may refuse on CUDA tensors, each with the abort that
# refuses it (gloo's TCP transport does not raise on point-to-point of
# device memory: one rank's writev fails and the process aborts)
MESH_MAY_REFUSE = {"batch_isend_irecv": "Bad address"}
MESH_PAIR_TIMEOUT_S = 300

# one collective on the card's tensors over a gloo pair; gloo's TCP
# transport aborts the process (it does not raise) on a collective it does
# not take for CUDA tensors, so each is probed in a pair of its own
MESH_PROBE_CHILD = r"""
import sys, torch, torch.distributed as dist
from modelx_tpu_torch.parallel import distributed
name, port, rank, device = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
distributed.initialize(f"127.0.0.1:{port}", 2, rank, device=device, backend="gloo",
                       timeout_s=60)
dev = distributed.local_device()
one = lambda dtype=torch.bfloat16: torch.ones(4, device=dev, dtype=dtype)
if name == "all_reduce":
    dist.all_reduce(one())
elif name == "all_gather":
    dist.all_gather([torch.empty_like(one()) for _ in range(2)], one())
elif name == "broadcast":
    dist.broadcast(one(torch.int64), src=0)
elif name == "all_to_all_single":
    dist.all_to_all_single(torch.empty_like(one()), one())
else:
    recv = torch.empty_like(one())
    for r in dist.batch_isend_irecv([dist.P2POp(dist.isend, one(), 1 - rank),
                                     dist.P2POp(dist.irecv, recv, 1 - rank)]):
        r.wait()
if dev.type == "cuda":
    torch.cuda.synchronize(dev)
print("PROBE_OK", flush=True)
distributed.shutdown()
"""
MESH_PROBES = ("all_reduce", "all_gather", "broadcast", "all_to_all_single",
               "batch_isend_irecv")

MESH_PAIR_CHILD = r"""
import gc, json, os, sys, time
import numpy as np, torch
from modelx_tpu_torch.dl.serve import ModelServer
from modelx_tpu_torch.ops import attention as attn
from modelx_tpu_torch.parallel import distributed
from modelx_tpu_torch.parallel.mesh import make_mesh

ckpt, port, rank, out_dir, device, runs, refused = sys.argv[1:8]
port, rank, runs, refused = int(port), int(rank), json.loads(runs), json.loads(refused)
distributed.initialize(f"127.0.0.1:{port}", 2, rank, device=device, backend="gloo",
                       timeout_s=float(os.environ.get("MESH_PAIR_TIMEOUT_S", "300")))
dev = distributed.local_device()
tokens = torch.as_tensor(np.load(os.path.join(out_dir, "tokens.npy")), device=dev)
result = {"runs": {}}
for spec, impl, needs in runs:
    key = f"{spec} {impl}"
    missing = sorted(set(needs) & set(refused))
    if missing:
        result["runs"][key] = {"skipped": missing}
        continue
    mesh = make_mesh(spec, device=dev)
    attn.flash_attention.launches = 0
    t0 = time.monotonic()
    server = ModelServer(ckpt, device=str(dev), mesh=mesh, attention_impl=impl)
    server.load()
    load_s = time.monotonic() - t0
    with torch.inference_mode():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.monotonic()
        logits = server.family.forward(server.params, tokens, server.cfg, mesh=mesh,
                                       attention_impl=impl)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        fwd_ms = (time.monotonic() - t0) * 1e3
    if rank == 0:
        torch.save(logits.cpu(), os.path.join(out_dir, key.replace(" ", "-").replace("=", "") + ".pt"))
    result["runs"][key] = {"launches": attn.flash_attention.launches, "load_s": load_s,
                           "forward_ms": fwd_ms, "rank_load_bytes": server.stats["rank_load_bytes"],
                           "device_bytes": server.stats["device_bytes"]}
    server.params = None
    del server, logits
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
print("MESH_PAIR", json.dumps(result), flush=True)
distributed.shutdown()
"""


def _mesh_pod(ckpt: str, device: str, spec: str, impl: str, root: str):
    """Start a ``serve_main --mesh`` child (``SERVE_CHILD``: its flash
    launches printed on its SIGTERM exit): (process, port, log path)."""
    port = _free_port()
    log_path = os.path.join(root, f"mesh-{re.sub(r'[^A-Za-z0-9]+', '-', spec)}-{impl}.log")
    log_f = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", SERVE_CHILD, "--model", f"{MODEL}={ckpt}", "--device", device,
         "--dtype", "bfloat16", "--listen", f"127.0.0.1:{port}", "--mesh", spec,
         "--sp-attention", impl, "--drain-seconds", "0"],
        cwd=REPO, env=_child_env(), stdout=log_f, stderr=subprocess.STDOUT)
    log_f.close()
    return proc, port, log_path


def _wait_mesh_pod(proc, port: int, log_path: str, what: str) -> None:
    deadline = time.monotonic() + 300
    while True:
        if proc.poll() is not None:
            raise RuntimeError(f"mesh: {what} exited {proc.returncode}: "
                               f"{open(log_path).read()[-3000:]}")
        try:
            if _http_raw(port, "/healthz")[0] == 200:
                return
        except OSError:
            pass
        if time.monotonic() > deadline:
            proc.kill()
            raise RuntimeError(f"mesh: {what} did not answer /healthz in 300 s")
        time.sleep(0.2)


def _mesh_probes(device: str, out_dir: str) -> dict:
    """Start a pair of processes for each collective of ``MESH_PROBES``,
    all at once: (name, rank) -> (process, log path)."""
    dev = "cuda:0" if device == "cuda" else "cpu"
    procs = {}
    for name in MESH_PROBES:
        port = _free_port()
        for rank in range(2):
            log_path = os.path.join(out_dir, f"probe-{name}-{rank}.log")
            with open(log_path, "w") as log_f:
                procs[(name, rank)] = (subprocess.Popen(
                    [sys.executable, "-c", MESH_PROBE_CHILD, name, str(port), str(rank), dev],
                    cwd=REPO, env=_child_env(), stdout=log_f, stderr=subprocess.STDOUT),
                    log_path)
    return procs


def _refused(probes: dict) -> dict:
    """Which collectives gloo refused on the device's tensors (the probe
    pairs of ``_mesh_probes``): name -> why. A refusal counts only for a
    collective of ``MESH_MAY_REFUSE`` and only with its abort (the signal,
    or the transport's error in a rank's log); any other failure of a
    probe, its timeout included, fails the phase."""
    outcome: dict = {}
    for (name, rank), (proc, log_path) in probes.items():
        try:
            rc = proc.wait(timeout=180)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "timeout"
        outcome.setdefault(name, []).append((rank, rc, open(log_path).read()))
    refused = {}
    for name, ranks in outcome.items():
        if all(rc == 0 and "PROBE_OK" in text for _, rc, text in ranks):
            continue
        why = "; ".join(f"rank {rank} exit {rc}: "
                        + " | ".join([ln for ln in text.splitlines() if ln.strip()][-2:])[:300]
                        for rank, rc, text in ranks)
        sign = MESH_MAY_REFUSE.get(name)
        if sign is None or not any(rc == -signal.SIGABRT or sign in text
                                   for _, rc, text in ranks):
            raise RuntimeError(f"mesh (b): the {name} probe failed ({why})")
        refused[name] = why
    return refused


def _mesh_pair(ckpt: str, device: str, out_dir: str, refused: dict) -> dict:
    """Part (b): two rank processes on the one card over gloo
    (``MESH_PAIR_CHILD``) run each of ``MESH_B_RUNS`` whose collectives
    were not ``refused``; rank 0's summary, with rank 1's as "peer"."""
    port = _free_port()
    runs = json.dumps([list(r) for r in MESH_B_RUNS])
    env = {**_child_env(), "MESH_PAIR_TIMEOUT_S": str(MESH_PAIR_TIMEOUT_S)}
    dev = "cuda:0" if device == "cuda" else "cpu"
    procs = []
    logs = [os.path.join(out_dir, f"pair-{r}.log") for r in range(2)]
    for rank in range(2):
        with open(logs[rank], "w") as log_f:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", MESH_PAIR_CHILD, ckpt, str(port), str(rank), out_dir,
                 dev, runs, json.dumps(sorted(refused))], cwd=REPO, env=env, stdout=log_f,
                stderr=subprocess.STDOUT))
    try:
        for rank, proc in enumerate(procs):
            if proc.wait(timeout=MESH_PAIR_TIMEOUT_S + 120) != 0:
                raise RuntimeError(f"mesh: pair rank {rank} exited {proc.returncode}: "
                                   f"{open(logs[rank]).read()[-4000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = [json.loads(line.split(" ", 1)[1]) for line in open(logs[0])
           if line.startswith("MESH_PAIR ")]
    peer = [json.loads(line.split(" ", 1)[1]) for line in open(logs[1])
            if line.startswith("MESH_PAIR ")]
    if not out or not peer:
        raise RuntimeError(f"mesh: the pair printed no summary: {open(logs[0]).read()[-3000:]}")
    out[0]["peer"] = peer[0]
    return out[0]


def phase_mesh(device: str = "cuda", cfg=None, parts: str = "ab") -> dict:
    """The serving mesh (module docstring, phase 14) on Llama-3-8B's widths
    at ``MESH_LAYERS`` layers; its flash launches counted from 0. The
    meshless server in process gives the references: ``/v1/forward``'s
    argmax at ``MESH_FORWARD``, a ``MESH_NEW_TOKENS`` greedy generate and
    the logits at [1, ``MESH_B_SEQ``]."""
    import dataclasses
    import gc
    import shutil

    import numpy as np
    import torch

    from modelx_tpu_torch.dl import safetensors as st
    from modelx_tpu_torch.dl.serve import ModelServer
    from modelx_tpu_torch.models import llama
    from modelx_tpu_torch.ops import attention as attn

    on_card = device == "cuda"
    cfg = cfg or dataclasses.replace(llama.LlamaConfig.llama3_8b(), num_layers=MESH_LAYERS)
    t_phase = time.monotonic()
    nbytes = 2 * sum(math.prod(x) for x in llama.param_shapes(cfg).values())
    root = _checkpoint_dir(nbytes)
    stats: dict = {"flash_launches_mesh": 0}
    pods, probes = {}, {}
    try:
        ckpt = os.path.join(root, "model")
        os.makedirs(ckpt)
        t0 = time.monotonic()
        params = llama.init_params(cfg, torch.Generator(device=device).manual_seed(18),
                                   dtype=torch.bfloat16)
        st.write_safetensors(os.path.join(ckpt, "model.safetensors"), params)
        del params
        log(f"mesh: wrote {nbytes / 1e9:.3f} GB ({cfg}) in {time.monotonic() - t0:.1f} s")
        rng = np.random.RandomState(18)
        fwd_tokens = rng.randint(0, cfg.vocab_size, MESH_FORWARD)
        prompt = rng.randint(0, cfg.vocab_size, (1, MESH_PROMPT))
        b_tokens = rng.randint(0, cfg.vocab_size, (1, MESH_B_SEQ))
        np.save(os.path.join(root, "tokens.npy"), b_tokens)
        # the (a) pods and (b)'s collective probes start together, while
        # the meshless server loads here
        runs_a = MESH_A_RUNS if "a" in parts else ()
        pods = {run: _mesh_pod(ckpt, device, *run, root) for run in runs_a}
        probes = _mesh_probes(device, root) if "b" in parts else {}
        plain = ModelServer(ckpt, dtype="bfloat16", device=device)
        plain.load()
        want_fwd = _uncounted(lambda: plain.forward_argmax(fwd_tokens)).tolist()
        want_gen = plain.generate(prompt, max_new_tokens=MESH_NEW_TOKENS)[0].tolist()
        with torch.inference_mode():
            want_b = _uncounted(lambda: plain.family.forward(
                plain.params, torch.as_tensor(b_tokens, device=plain.device),
                plain.cfg)).float().cpu()

        # (a) one rank over NCCL through the entry point
        per_forward = cfg.num_layers if on_card else 0
        for (spec, impl), (proc, port, log_path) in pods.items():
            try:
                _wait_mesh_pod(proc, port, log_path, f"serve_main --mesh {spec}")
                start_s = time.monotonic() - t_phase
                status, body = _http(port, "/v1/forward", {"tokens": fwd_tokens.tolist()})
                if status != 200:
                    raise RuntimeError(f"mesh {spec} {impl}: /v1/forward answered {status} {body}")
                got_fwd = body["logits_argmax"]
                status, body = _http(port, "/v1/generate", {"tokens": prompt.tolist(),
                                                            "max_new_tokens": MESH_NEW_TOKENS})
                if status != 200:
                    raise RuntimeError(f"mesh {spec} {impl}: /v1/generate answered {status} {body}")
                got_gen = body["tokens"][0]
                _, models = _http(port, "/v1/models")
                mstats = models["models"][MODEL]
            finally:
                launches = _stop_serve_child(proc, log_path, f"mesh {spec} {impl}")
            banner = f"serving mesh {spec} (1 device(s), weight shard factor 1)"
            if banner not in open(log_path).read():
                raise RuntimeError(f"mesh {spec} {impl}: no {banner!r} line in the pod's log")
            if (mstats["mesh"], mstats["mesh_devices"]) != (spec, 1):
                raise RuntimeError(f"mesh {spec} {impl}: the pod reports {mstats['mesh']}, "
                                   f"{mstats['mesh_devices']} device(s)")
            if got_gen != want_gen:
                raise RuntimeError(f"mesh {spec} {impl}: the greedy generate differs from the "
                                   f"meshless path's")
            if impl == "ring":
                # the ring merges in plain torch: each differing argmax a near tie
                how = check_forward_ties(plain, fwd_tokens, got_fwd, want_fwd,
                                         f"mesh {spec} ring /v1/forward")
                want_launches = 0
            else:
                if got_fwd != want_fwd:
                    raise RuntimeError(f"mesh {spec} {impl}: /v1/forward differs from the "
                                       f"meshless path's (want bit for bit)")
                how = "equal bit for bit"
                want_launches = 2 * per_forward  # the warm-up and the forward
            if launches != want_launches:
                raise RuntimeError(f"mesh {spec} {impl}: {launches} flash launches, want "
                                   f"{want_launches}")
            key = f"mesh_a_{spec}_{impl}"
            stats[key] = {"launches": launches, "ready_s": start_s, "forward": how}
            stats["flash_launches_mesh"] += launches
            backend = "NCCL" if on_card else "gloo"
            log(f"mesh (a) --mesh {spec} --sp-attention {impl}, one rank over {backend}: "
                f"/v1/forward {list(MESH_FORWARD)} {how}; {MESH_NEW_TOKENS}-token greedy "
                f"generate equal; {launches} flash launches; ready {start_s:.1f} s into "
                f"the phase")
        _free(plain)
        del plain
        gc.collect()

        # (b) two ranks on the one card over gloo
        if "b" in parts:
            t0 = time.monotonic()
            refused = _refused(probes)
            for name, why in refused.items():
                log(f"mesh (b): gloo refused {name} on {'CUDA' if on_card else 'CPU'} "
                    f"tensors ({why})")
            stats["mesh_b_refused"] = sorted(refused)
            stats["mesh_b_probe_s"] = time.monotonic() - t0
            pair = _mesh_pair(ckpt, device, root, refused)
            stats["mesh_b_s"] = time.monotonic() - t0
            for key, run in pair["runs"].items():
                if "skipped" in run:
                    if key.endswith("ring"):
                        log(f"mesh (b): {key} left out: gloo refused "
                            f"{', '.join(run['skipped'])}")
                        continue
                    # tp=2 and Ulysses are the phase's only two-rank checks
                    raise RuntimeError(f"mesh (b): {key} left out: gloo refused "
                                       f"{', '.join(run['skipped'])}")
                got = torch.load(os.path.join(root, key.replace(" ", "-").replace("=", "")
                                              + ".pt")).float()
                err = float((got - want_b).abs().max())
                tol = MESH_B_TOL[key]
                if not err <= tol:
                    raise RuntimeError(f"mesh (b) {key}: logits differ from the meshless "
                                       f"forward's by {err:.4f} (tolerance {tol})")
                launches = run["launches"] + pair["peer"]["runs"][key]["launches"]
                if on_card and key.endswith(("auto", "ulysses")) and launches == 0:
                    raise RuntimeError(f"mesh (b) {key}: the flash kernel was not launched")
                stats["flash_launches_mesh"] += launches
                stats[f"mesh_b_{key}"] = {**run, "max_abs_err": err, "tolerance": tol,
                                           "launches_both": launches}
                log(f"mesh (b) {key}, two ranks over gloo: logits [1,{MESH_B_SEQ}] within "
                    f"{err:.4f} of the meshless forward's (tolerance {tol}); forward "
                    f"{run['forward_ms']:.1f} ms, load {run['load_s']:.1f} s, rank 0 read "
                    f"{run['rank_load_bytes'] / 1e9:.3f} GB of {nbytes / 1e9:.3f}; "
                    f"{launches} flash launches on the two ranks")
    finally:
        # every child this phase started ends with it
        for proc, *_ in list(pods.values()) + list(probes.values()):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    stats["mesh_phase_s"] = time.monotonic() - t_phase
    stats["mesh_bytes_written"] = nbytes
    log(f"mesh: the phase took {stats['mesh_phase_s']:.1f} s, wrote {nbytes / 1e9:.3f} GB "
        f"(deleted); {stats['flash_launches_mesh']} flash launches on its paths")
    return stats


if __name__ == "__main__":
    sys.exit(main())
