"""``modelx-train-torch``: the training loop on one card (counterpart of
``modelx_tpu/models/train_main.py``'s ``modelx-train``).

    modelx-train-torch --model-dir DIR --data tokens.npy --batch 8 --seq 512 \\
        --steps 100 --checkpoint-dir CK [--push http://registry/library/run@v1]

pull (or init) -> load onto the card -> train -> checkpoint shards -> push
(content-addressed: only changed layer shards upload). The flags, defaults,
data stream, resume cursor, messages and the last JSON line are
``modelx-train``'s. Data is a token stream: an int32 ``.npy``/``.bin`` of
token ids, or ``synthetic`` (the same stream as the reference's, from
``np.random.RandomState(0)``). Sequences are consecutive windows; targets
are the inputs shifted by one. Resume is automatic when the checkpoint
directory holds a prior state.

``--device`` (default ``cuda``, which raises without a card; ``cpu`` when
asked) picks the one device. ``--mesh`` takes an empty value or ``dp=1``;
any other mesh, and ``--fsdp``, are refused: they come with the
multi-device slice.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import sys
import time

import numpy as np

logger = logging.getLogger("modelx.train")

CONFIGS = ("tiny", "llama3_8b", "llama3_70b")


class TrainError(Exception):
    """A usage or data error: ``Error: <message>`` on stderr, exit code 1
    (the reference's ``click.ClickException``)."""


class MultiDeviceError(TrainError):
    """A mesh other than one device, or ``--fsdp``: the multi-device slice's."""


def _load_tokens(data: str, vocab_size: int, steps: int, batch: int, seq: int) -> np.ndarray:
    """Token id stream as a flat int32 array (memmapped when on disk)."""
    if data == "synthetic":
        rng = np.random.RandomState(0)
        return rng.randint(1, vocab_size, steps * batch * (seq + 1)).astype(np.int32)
    if data.endswith(".npy"):
        arr = np.load(data, mmap_mode="r")
    else:
        arr = np.memmap(data, dtype=np.int32, mode="r")
    if arr.ndim != 1:
        arr = arr.reshape(-1)
    return arr


def _batches(tokens: np.ndarray, steps: int, batch: int, seq: int,
             start_step: int = 0, vocab_size: int | None = None):
    """Consecutive [B, S+1] windows -> {"tokens", "targets"}; wraps around.
    ``start_step`` places the cursor where a resumed run left off. Ids are
    checked against ``vocab_size``: an id past the embedding would be a
    device-side assert on the card (the reference's XLA gather clamps it)."""
    need = batch * (seq + 1)
    total = len(tokens)
    if total < need:
        raise TrainError(f"data holds {total} tokens; one step needs {need} (batch*(seq+1))")
    per_epoch = total // need
    off = (start_step % per_epoch) * need
    for _ in range(steps):
        if off + need > total:
            off = 0
        window = np.asarray(tokens[off : off + need]).reshape(batch, seq + 1)
        off += need
        if vocab_size is not None:
            hi, lo = int(window.max()), int(window.min())
            if hi >= vocab_size or lo < 0:
                raise TrainError(
                    f"data contains token id {hi if hi >= vocab_size else lo}, "
                    f"outside the model's vocab [0, {vocab_size}) — wrong tokenizer?"
                )
        yield {"tokens": window[:, :-1].copy(), "targets": window[:, 1:].copy()}


def _scan_model_dir(model_dir: str):
    """(config, shard paths) from the checkpoint headers alone (no weight
    bytes)."""
    from modelx_tpu_torch.dl import families as fam
    from modelx_tpu_torch.dl.safetensors import read_header_from_file

    paths = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if not paths:
        raise TrainError(f"no safetensors under {model_dir}")
    infos: dict = {}
    for p in paths:
        h, _ = read_header_from_file(p)
        infos.update(h)
    return fam.infer_llama_config(fam.abstract_params(infos)), paths


def _check_mesh(mesh_spec: str, fsdp: bool) -> dict:
    """The one-device mesh's shape, or a refusal of any other."""
    if fsdp:
        raise MultiDeviceError("--fsdp shards params over devices: FSDP comes with the "
                               "multi-device slice; this trainer runs on one device")
    spec = mesh_spec.replace(" ", "")
    if spec not in ("", "dp=1"):
        raise MultiDeviceError(f"--mesh {mesh_spec!r}: meshes other than dp=1 come with the "
                               "multi-device slice; this trainer runs on one device")
    return {"dp": 1}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="modelx-train-torch",
        description="Train a llama-family model on one device, checkpointing through the "
                    "registry's content-addressed store.")
    ap.add_argument("--model-dir", default="",
                    help="checkpoint dir with *.safetensors to start from")
    ap.add_argument("--config", default="tiny", choices=CONFIGS,
                    help="llama config when starting fresh")
    ap.add_argument("--data", default="synthetic",
                    help="token id stream: .npy / int32 .bin / 'synthetic'")
    ap.add_argument("--mesh", dest="mesh_spec", default="",
                    help='"" or "dp=1" (one device; other meshes come with the multi-device slice)')
    ap.add_argument("--fsdp", action="store_true",
                    help="refused: FSDP comes with the multi-device slice")
    ap.add_argument("--steps", default=100, type=int,
                    help="steps to run NOW (a resumed run trains this many MORE)")
    ap.add_argument("--batch", default=8, type=int)
    ap.add_argument("--seq", default=512, type=int)
    ap.add_argument("--lr", default=3e-4, type=float)
    ap.add_argument("--checkpoint-dir", default="",
                    help="save/resume dir (layer-sharded safetensors)")
    ap.add_argument("--checkpoint-every", default=100, type=int)
    ap.add_argument("--push", dest="push_uri", default="",
                    help="push the checkpoint here when done (registry URI)")
    ap.add_argument("--log-every", default=10, type=int)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N or cpu); cuda raises when absent")
    return ap


def run(argv=None) -> dict:
    """Parse ``argv`` and train; returns the summary the last line prints."""
    args = build_parser().parse_args(argv)
    if args.push_uri and not args.checkpoint_dir:
        raise TrainError("--push requires --checkpoint-dir (the pushed artifact)")
    mesh_shape = _check_mesh(args.mesh_spec, args.fsdp)

    import torch

    from modelx_tpu_torch.device import resolve_device
    from modelx_tpu_torch.dl.checkpoint import Checkpointer
    from modelx_tpu_torch.models import llama
    from modelx_tpu_torch.models.train import make_optimizer, make_train_step

    device = resolve_device(args.device)
    # -- model: resume > checkpoint dir > fresh config ------------------------
    ckpt = Checkpointer(args.checkpoint_dir) if args.checkpoint_dir else None
    resuming = ckpt is not None and os.path.exists(os.path.join(ckpt.directory, "checkpoint.json"))
    start_step = 0
    optimizer = make_optimizer(lr=args.lr)
    if args.model_dir:
        cfg, shard_paths = _scan_model_dir(args.model_dir)
    else:
        cfg, shard_paths = getattr(llama.LlamaConfig, args.config)(), []
    if resuming:
        # restore needs only names and shapes from its templates: meta
        # tensors, no random init to throw away
        abstract = {n: torch.empty(s, dtype=cfg.dtype, device="meta")
                    for n, s in llama.param_shapes(cfg).items()}
        params, opt_state, start_step = ckpt.restore(abstract, optimizer.init(abstract),
                                                     device=device)
        logger.info("resumed from step %d (%s)", start_step, ckpt.directory)
    elif args.model_dir:
        from modelx_tpu_torch.dl.loader import LocalFileSource, load_safetensors

        params = {}
        for p in shard_paths:
            src = LocalFileSource(p)
            try:
                arrays, _ = load_safetensors(src, device)
            finally:
                src.close()
            params.update(arrays)
        opt_state = optimizer.init(params)
    else:
        gen = torch.Generator(device=device).manual_seed(0)
        params = llama.init_params(cfg, gen, device=device)
        opt_state = optimizer.init(params)

    step_fn = make_train_step(cfg, optimizer)
    tokens = _load_tokens(args.data, cfg.vocab_size, args.steps, args.batch, args.seq)

    t0 = time.monotonic()
    losses = []
    n = last_saved = start_step
    for batch_np in _batches(tokens, args.steps, args.batch, args.seq, start_step=start_step,
                             vocab_size=cfg.vocab_size):
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch_np.items()}
        params, opt_state, loss = step_fn(params, opt_state, batch)
        n += 1
        if n % args.log_every == 0 or n == start_step + args.steps:
            loss_f = float(loss)
            losses.append(loss_f)
            dt = time.monotonic() - t0
            logger.info("step %d  loss %.4f  %.0f tok/s", n, loss_f,
                        (n - start_step) * args.batch * args.seq / dt)
        if ckpt is not None and args.checkpoint_every and n % args.checkpoint_every == 0:
            _save(ckpt, params, opt_state, n)
            last_saved = n
    if ckpt is not None and n > last_saved:
        _save(ckpt, params, opt_state, n)
    if ckpt is not None and args.push_uri:  # push regardless of save boundaries
        ckpt.push(args.push_uri)
        logger.info("pushed checkpoint to %s", args.push_uri)
    return {
        "steps": n, "final_loss": losses[-1] if losses else None,
        "tokens_per_s": round((n - start_step) * args.batch * args.seq
                              / (time.monotonic() - t0), 1),
        "mesh": str(mesh_shape),
    }


def _save(ckpt, params, opt_state, step: int) -> None:
    ckpt.save(params, opt_state, step=step)
    logger.info("checkpointed step %d -> %s", step, ckpt.directory)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    try:
        summary = run(argv)
    except TrainError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
