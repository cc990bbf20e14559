"""Training step on one card: loss, gradients and the AdamW update
(counterpart of ``modelx_tpu/models/train.py``).

The JAX step is ``jax.value_and_grad`` of the llama forward plus optax's
``adamw``; here the forward is the port's llama forward, the gradients are
autograd's, and the update is written out (``AdamW``) so that it computes
what optax computes, leaf by leaf. On the card ``attention_impl="auto"`` is
the flash kernel, so the gradient runs through the hand-written backward
kernel (``ops/attention.FlashAttentionFunction``), as the TPU reference
trains through its Pallas kernel.

The placement half of the reference's multi-device training is here as
per-rank slices: ``shard_params`` (this rank's slice of each param, by the
family rules) and ``batch_rows`` (this rank's rows and tokens of a batch,
the reference's ``batch_sharding``). The sharded step itself
(``param_shardings``, ``jit_train_step`` and ``make_train_step(mesh=)``)
comes with the multi-device training slice.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch
import torch.nn.functional as F

from modelx_tpu_torch.models import llama

MULTI_DEVICE = "meshes (data, FSDP, tensor and pipeline parallel) come with the multi-device slice"


def shard_params(params: dict, rules, mesh) -> dict:
    """This rank's slice of each (whole) param under ``rules`` on ``mesh``
    (reference ``:68``, which places the whole params on the mesh). It
    follows the rule table, the reference's placement, and not the serving
    forward's ``llama.ShardingCtx``, which replicates a weight whose heads
    do not divide tp."""
    from modelx_tpu_torch.dl.sharding import sharding_for

    return {name: t[sharding_for(name, rules, mesh).index(t.shape)].contiguous()
            for name, t in params.items()}


def batch_rows(batch: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's part of a [B, S, ...] batch (reference ``batch_sharding
    :76``): rows over dp and fsdp together, tokens over sp, each where the
    mesh has the axis and it divides."""
    from modelx_tpu_torch.dl.sharding import Sharding

    rows = tuple(a for a in ("dp", "fsdp") if a in mesh.axis_names) or None
    seq = "sp" if "sp" in mesh.axis_names else None
    return batch[Sharding(mesh, (rows, seq)).index(batch.shape[:2])]


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy in fp32. logits [B,S,V], targets [B,S]."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return nll.mean()


@dataclasses.dataclass
class AdamWState:
    """optax ``adamw``'s state: its chain's first member (index 0) holds
    ``count`` (0-d int32) and the moments ``mu`` and ``nu`` (one per param,
    in the param's dtype and on its device); the decay and learning-rate
    members hold none. ``dl/checkpoint.py`` names the leaves as optax's
    tree paths: ``0|count``, ``0|mu|<param>``, ``0|nu|<param>``."""

    count: torch.Tensor
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax.adamw(lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay) written out,
    the decay on every parameter (optax's default mask). One step, per
    leaf, as optax orders it:

        mu = (1 - b1) g + b1 mu;   nu = (1 - b2) g^2 + b2 nu;   count += 1
        u = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
        p = p + (-lr) (u + weight_decay p)

    Bias correction: optax divides each moment by ``1 - b**count`` computed
    in fp32 (``optax.tree.bias_correction``: a Python float to an int32
    power) and cast to the moment's dtype; here it is ``1 - b**count`` in
    Python's float64, rounded to fp32 where it meets an fp32 moment. The
    two differ by at most an fp32 rounding of that scalar. The arithmetic
    runs in fp32 and the moments and params are stored back in the
    param's dtype (optax keeps the moments in the param dtype and, for
    bf16 params, rounds after every operation; here once a leaf). The
    update is in place: the params and moments are overwritten, no second
    copy of the state is made."""

    lr: float = 3e-4
    weight_decay: float = 0.1

    B1: ClassVar[float] = 0.9
    B2: ClassVar[float] = 0.95
    EPS: ClassVar[float] = 1e-8

    def init(self, params: dict[str, torch.Tensor]) -> AdamWState:
        """Zero moments shaped like ``params`` (meta params give meta moments:
        a template for ``Checkpointer.restore``)."""
        first = next(iter(params.values()), None)
        dev = first.device if first is not None else None
        return AdamWState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            mu={n: torch.zeros_like(p) for n, p in params.items()},
            nu={n: torch.zeros_like(p) for n, p in params.items()},
        )

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor], state: AdamWState,
               params: dict[str, torch.Tensor]) -> tuple[dict[str, torch.Tensor], AdamWState]:
        """One AdamW step on every param; returns (params, state), both
        updated in place."""
        count = int(state.count) + 1
        bc1 = 1.0 - self.B1 ** count
        bc2 = 1.0 - self.B2 ** count
        for name, p in params.items():
            g = grads[name].float()
            mu = (1.0 - self.B1) * g + self.B1 * state.mu[name].float()
            nu = (1.0 - self.B2) * (g * g) + self.B2 * state.nu[name].float()
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.EPS)
            u = -self.lr * (u + self.weight_decay * p.float())
            p.copy_(p.float() + u)
            state.mu[name].copy_(mu)
            state.nu[name].copy_(nu)
        state.count.fill_(count)
        return params, state


def make_optimizer(lr: float = 3e-4, weight_decay: float = 0.1) -> AdamW:
    """The reference's ``optax.adamw(lr, b1=0.9, b2=0.95,
    weight_decay=weight_decay)``."""
    return AdamW(lr=lr, weight_decay=weight_decay)


def loss_and_grads(params: dict[str, torch.Tensor], batch: dict, forward_fn
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor | None]]:
    """(loss, {name: grad}) of the mean cross entropy of
    ``forward_fn(params, batch["tokens"])`` against ``batch["targets"]``. A
    param the forward does not reach gets None (autograd's
    ``allow_unused``), so a caller can see a graph that was cut."""
    names = list(params)
    leaves = [params[n].detach().requires_grad_(True) for n in names]
    with torch.enable_grad():
        logits = forward_fn(dict(zip(names, leaves)), batch["tokens"])
        loss = cross_entropy_loss(logits, batch["targets"])
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), dict(zip(names, grads))


def make_train_step(cfg: llama.LlamaConfig, optimizer: AdamW, mesh=None, forward_fn=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, loss).

    ``batch`` = {"tokens": [B,S] int, "targets": [B,S] int} on the params'
    device. ``forward_fn(params, tokens) -> logits`` overrides the default
    llama forward (``attention_impl="auto"``: the flash kernels on the
    card). A param that gets no gradient raises: it means the forward's
    graph was cut, and optax would see a zero there instead."""
    if mesh is not None:
        raise NotImplementedError(MULTI_DEVICE)
    if forward_fn is None:
        def forward_fn(params, tokens):
            logits, _ = llama.forward(params, tokens, cfg)
            return logits

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch, forward_fn)
        missing = sorted(n for n, g in grads.items() if g is None)
        if missing:
            raise RuntimeError(f"no gradient reached {missing[:4]}: the forward's graph is cut")
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, loss

    return train_step
