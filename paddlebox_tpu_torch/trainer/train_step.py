"""The step over a host table (counterpart of
``paddlebox_tpu/trainer/train_step.py``): the host-table engine's step,
and the pieces the fused step shares.

``TrainStep.__call__`` (the caller pulls and pushes a host ``ps/table.py``
``EmbeddingTable`` around it):

    (params, opt_state, auc_state, emb[Npad, D], segment_ids[Npad],
     cvm_in[B, 2], labels[B(, T)], dense[B, Dd], row_mask[B])
    -> (params, opt_state, auc_state, demb[Npad, D], loss, preds)

``emb`` goes up, becomes a leaf that requires grad and runs through
seqpool+CVM (``ops/seqpool_cvm.py``: CUDA kernels forward and backward on
the card), the model and the masked BCE loss; the backward, the dense
optimizer and the AUC update run on the device, and ``demb`` comes back as
a host array for the push. ``predict`` is the forward alone, for
``evaluate`` and serving. The module passed as ``params`` holds the
weights (the role of the reference's params pytree).

Shared with ``trainer.fused_step.FusedTrainStep``: ``make_dense_optimizer``
(optax's math for adam, adamw, sgd, adagrad, lars and lamb, with
``optax.MultiSteps`` gradient merging, updating a module's parameters in
place), ``apply_model`` (the forward, under ``recompute`` through
``torch.utils.checkpoint``) and ``masked_bce_loss`` (the reference's
``_loss_fn``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from paddlebox_tpu_torch._device import DeviceLike, resolve_device
from paddlebox_tpu_torch.config import TableConfig, TrainerConfig
from paddlebox_tpu_torch.metrics.auc import auc_update, new_auc_state
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm

# optax's defaults: adam(b1, b2, eps), adagrad(initial accumulator, eps),
# lars(trust coefficient, momentum), lamb(eps)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
ADAGRAD_INIT, ADAGRAD_EPS = 0.1, 1e-7
LARS_TRUST, LARS_MOMENTUM = 0.001, 0.9
LAMB_EPS = 1e-6

DENSE_OPTIMIZERS = ("adam", "adamw", "sgd", "adagrad", "lars", "lamb")


def full_float32_matmuls() -> None:
    """The model's matmuls run in full float32, as in the JAX reference:
    TF32 keeps about three decimal digits. The flags are process-wide."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _trust_ratio(u: torch.Tensor, p: torch.Tensor,
                 coeff: float) -> torch.Tensor:
    """optax's ``scale_by_trust_ratio`` of one leaf (min_norm 0, eps 0):
    ``u * coeff * |p| / |u|``, the ratio 1 where either norm is 0."""
    pn = torch.linalg.vector_norm(p)
    un = torch.linalg.vector_norm(u)
    ratio = coeff * pn / un
    ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(ratio),
                        ratio)
    return u * ratio


class DenseOptimizer:
    """A dense optimizer in optax 0.2.6's math. ``init(model)`` makes the
    state; ``update(model, state)`` applies one step from the parameters'
    ``.grad`` (a parameter without a grad counts as a zero grad), in
    place, and returns the state; it reads nothing back to the host, so a
    captured run (``trainer/step_graph.py``) replays it. Note that optax's
    adagrad starts its accumulator at 0.1 and adds eps 1e-7 inside the
    square root, where ``torch.optim.Adagrad`` starts at 0 and adds 1e-10
    outside it.

    ``lars`` and ``lamb`` take their norms per parameter tensor, each a
    leaf of the reference's params (``models/convert.py``). ``every_k`` >
    1 is ``optax.MultiSteps``: the running mean of the grads accumulates
    every step, and every k-th step (``emit``) the inner optimizer takes
    it; the inner update is computed every step and selected on the
    device, so the state advances only on emit and the parameters move by
    ``emit * update``."""

    def __init__(self, name: str, learning_rate: float,
                 weight_decay: float = 0.0, every_k: int = 1):
        if name not in DENSE_OPTIMIZERS:
            raise ValueError(f"unknown dense optimizer {name!r}")
        self.name = name
        self.lr = learning_rate
        self.weight_decay = weight_decay
        self.every_k = int(every_k)

    def _init_inner(self, params: List[torch.Tensor]) -> Dict[str, Any]:
        if self.name in ("adam", "adamw", "lamb"):
            # optax's ScaleByAdamState.count: an int32 on the device, so
            # that a captured step advances it
            dev = params[0].device if params else None
            return {"count": torch.zeros((), dtype=torch.int32, device=dev),
                    "mu": [torch.zeros_like(p) for p in params],
                    "nu": [torch.zeros_like(p) for p in params]}
        if self.name == "adagrad":
            return {"sum_of_squares": [torch.full_like(p, ADAGRAD_INIT)
                                       for p in params]}
        if self.name == "lars":
            return {"trace": [torch.zeros_like(p) for p in params]}
        return {}

    def init(self, model: nn.Module) -> Dict[str, Any]:
        params = list(model.parameters())
        inner = self._init_inner(params)
        if self.every_k <= 1:
            return inner
        # optax's MultiStepsState (skip_state holds no leaf)
        dev = params[0].device if params else None
        return {"mini_step": torch.zeros((), dtype=torch.int32, device=dev),
                "gradient_step": torch.zeros((), dtype=torch.int32,
                                             device=dev),
                "inner": inner,
                "acc_grads": [torch.zeros_like(p) for p in params]}

    def _updates(self, params: List[torch.Tensor],
                 grads: List[torch.Tensor], state: Dict[str, Any]
                 ) -> Tuple[List[torch.Tensor], Dict[str, Any]]:
        """The inner optimizer's updates (added to the parameters) and its
        next state, computed out of place."""
        lr, wd = self.lr, self.weight_decay
        name = self.name
        if name in ("adam", "adamw", "lamb"):
            count = state["count"] + 1
            # optax's bias corrections, 1 - b ** count in f32, on the device
            t = count.float()
            bc1 = 1 - ADAM_B1 ** t
            bc2 = 1 - ADAM_B2 ** t
            eps = LAMB_EPS if name == "lamb" else ADAM_EPS
            mus, nus, ups = [], [], []
            for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
                mu = (1 - ADAM_B1) * g + ADAM_B1 * mu
                nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * nu
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
                if name != "adam":
                    u = u + wd * p
                if name == "lamb":
                    u = _trust_ratio(u, p, 1.0)
                mus.append(mu)
                nus.append(nu)
                ups.append(-lr * u)
            return ups, {"count": count, "mu": mus, "nu": nus}
        if name == "adagrad":
            soss, ups = [], []
            for g, sos in zip(grads, state["sum_of_squares"]):
                sos = g * g + sos
                inv = torch.where(sos > 0, torch.rsqrt(sos + ADAGRAD_EPS),
                                  sos.new_zeros(()))
                soss.append(sos)
                ups.append(-lr * (inv * g))
            return ups, {"sum_of_squares": soss}
        if name == "lars":
            traces = []
            for p, g, tr in zip(params, grads, state["trace"]):
                u = _trust_ratio(g + wd * p, p, LARS_TRUST)
                traces.append((-lr * u) + LARS_MOMENTUM * tr)
            return traces, {"trace": traces}
        return [-lr * g for g in grads], {}

    @staticmethod
    def _assign(state: Dict[str, Any], new: Dict[str, Any],
                emit: Optional[torch.Tensor] = None) -> None:
        """Copy ``new`` into ``state`` in place (where ``emit``, if given)."""
        for field, v in new.items():
            olds = state[field]
            pairs = ([(olds, v)] if isinstance(v, torch.Tensor)
                     else zip(olds, v))
            for old, nv in pairs:
                old.copy_(nv if emit is None else torch.where(emit, nv, old))

    @torch.no_grad()
    def update(self, model: nn.Module,
               state: Dict[str, Any]) -> Dict[str, Any]:
        params: List[torch.Tensor] = list(model.parameters())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if self.every_k <= 1:
            updates, new = self._updates(params, grads, state)
            self._assign(state, new)
            for p, u in zip(params, updates):
                p.add_(u)
            return state
        # optax.MultiSteps(use_grad_mean=True): the running mean, the inner
        # update on it, and the emit select, all on the device
        mini = state["mini_step"]
        acc = [a + (g - a) / (mini + 1)
               for a, g in zip(state["acc_grads"], grads)]
        updates, new = self._updates(params, acc, state["inner"])
        emit = mini == self.every_k - 1
        emit_i = emit.to(torch.int32)
        self._assign(state["inner"], new, emit)
        for a, na in zip(state["acc_grads"], acc):
            a.copy_((1 - emit_i) * na)
        gstep = state["gradient_step"]
        gstep.copy_(emit_i * (gstep + 1) + (1 - emit_i) * gstep)
        mini.copy_((mini + 1) % self.every_k)
        for p, u in zip(params, updates):
            p.add_(emit_i * u)
        return state


def compute_dtype(conf: TrainerConfig) -> torch.dtype:
    """The dtype ``FusedTrainStep`` casts the model's inputs to: bfloat16
    under ``bf16``, as the reference's ``FusedTrainStep.compute_dtype``.
    With a float32 model that only rounds its inputs to bfloat16 (the
    model casts them back); a model of ``dtype`` bfloat16 computes in it.
    The host-table ``TrainStep`` ignores the flag, as the reference's
    does."""
    return torch.bfloat16 if conf.bf16 else torch.float32


def make_dense_optimizer(conf: TrainerConfig) -> DenseOptimizer:
    """The dense-tower optimizer of ``conf``: adam, adamw, sgd, adagrad,
    lars or lamb, wrapped in gradient merging (``optax.MultiSteps``) when
    ``grad_merge_steps`` > 1."""
    return DenseOptimizer(conf.dense_optimizer, conf.dense_learning_rate,
                          conf.dense_weight_decay,
                          max(int(conf.grad_merge_steps), 1))


def apply_model(model: nn.Module, sparse: torch.Tensor,
                dense: torch.Tensor, recompute: bool) -> torch.Tensor:
    """``model(sparse, dense)``; with ``recompute`` (the reference's
    ``jax.checkpoint(model.apply)``) the forward keeps no activations and
    runs again inside the backward. The models draw no random numbers, so
    the replay saves no RNG state (which a captured graph cannot read)."""
    if recompute and torch.is_grad_enabled():
        return checkpoint(model, sparse, dense, use_reentrant=False,
                          preserve_rng_state=False)
    return model(sparse, dense)


def sigmoid_binary_cross_entropy(logits: torch.Tensor,
                                 labels: torch.Tensor) -> torch.Tensor:
    """optax's form: ``-y log(sigmoid(x)) - (1 - y) log(sigmoid(-x))``."""
    labels = labels.to(logits.dtype)
    return -labels * F.logsigmoid(logits) - \
        (1.0 - labels) * F.logsigmoid(-logits)


def masked_bce_loss(logits: torch.Tensor, labels: torch.Tensor,
                    row_mask: torch.Tensor,
                    den: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``sum(losses * mask) / max(den, 1)`` and the predictions; ``den``
    the mask's sum, or a mesh shard's global denominator (the shards'
    mask sums summed, ``parallel/plan.py``), which makes the loss that
    shard's share of the global mean."""
    if logits.dim() == 1 and labels.dim() == 2:
        labels = labels[:, 0]
    mask = row_mask if logits.dim() == 1 else row_mask[:, None]
    losses = sigmoid_binary_cross_entropy(logits, labels) * mask
    den = mask.sum() if den is None else den.to(logits.device)
    loss = losses.sum() / torch.clamp(den, min=1.0)
    return loss, torch.sigmoid(logits)


class TrainStep:
    """The step over a host table (the reference's ``TrainStep``): the
    caller pulls the batch's rows from a host ``EmbeddingTable``, the step
    runs on ``device`` (None = the card) and hands back the embedding
    grads for the caller's push. ``params`` is the ``nn.Module`` holding
    the dense weights (``init`` moves ``model`` to the device); the dense
    optimizer updates it in place. As the reference's ``TrainStep``, it
    ignores ``TrainerConfig.bf16``: the model takes float32 inputs (a
    model of ``dtype`` bfloat16 casts them itself)."""

    def __init__(self, model: nn.Module, table_conf: TableConfig,
                 trainer_conf: TrainerConfig, batch_size: int,
                 num_slots: int, dense_dim: int = 0, use_cvm: bool = True,
                 num_auc_buckets: int = 0,
                 seqpool_kwargs: Optional[Dict[str, Any]] = None,
                 device: DeviceLike = None):
        full_float32_matmuls()
        self.model = model
        self.table_conf = table_conf
        self.trainer_conf = trainer_conf
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.num_slots = num_slots
        self.dense_dim = dense_dim
        self.use_cvm = use_cvm
        self.num_auc_buckets = num_auc_buckets
        self.seqpool_kwargs = dict(seqpool_kwargs or {})
        self.optimizer = make_dense_optimizer(trainer_conf)
        self.recompute = bool(trainer_conf.recompute)

    def init(self) -> Tuple[nn.Module, Dict[str, Any]]:
        """The model, moved to the step's device, and a fresh optimizer
        state. The weights are the model's own (for parity runs: converted
        from the reference's flax params)."""
        params = self.model.to(self.device)
        return params, self.optimizer.init(params)

    def init_auc_state(self) -> Dict[str, torch.Tensor]:
        return new_auc_state(self.num_auc_buckets, self.device)

    def _features(self, emb: torch.Tensor, segment_ids: torch.Tensor,
                  cvm_in: torch.Tensor) -> torch.Tensor:
        return fused_seqpool_cvm(
            emb, segment_ids, cvm_in, self.batch_size, self.num_slots,
            self.use_cvm, **self.seqpool_kwargs)

    def _tensor(self, x, dtype: np.dtype) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(
            self.device)

    def __call__(self, params: nn.Module, opt_state: Dict[str, Any],
                 auc_state: Dict[str, torch.Tensor], emb: np.ndarray,
                 segment_ids, cvm_in, labels, dense, row_mask):
        """One step over the pulled rows ``emb`` [Npad, pull_dim] (host
        float32): seqpool+CVM, the model, the masked BCE loss (labels [B]
        or [B, T]), the backward (the seqpool's straight-through rule), the
        dense update in place and the AUC on task 0. Returns ``(params,
        opt_state, auc_state, demb, loss, preds)``: ``demb`` the host
        float32 [Npad, pull_dim] grads for ``EmbeddingTable.push`` (show/
        clk in its first columns; its download is the step's one
        synchronization), ``loss`` and ``preds`` device tensors."""
        with record_function("train_step.upload"):
            emb_d = self._tensor(emb, np.float32)
            segs = self._tensor(segment_ids, np.int32)
            cvm = self._tensor(cvm_in, np.float32)
            labels_d = self._tensor(labels, np.float32)
            dense_d = self._tensor(dense, np.float32)
            mask = self._tensor(row_mask, np.float32)
        with record_function("train_step.forward"):
            emb_d.requires_grad_(True)
            params.zero_grad(set_to_none=True)
            logits = apply_model(params, self._features(emb_d, segs, cvm),
                                 dense_d, self.recompute)
            loss, preds = masked_bce_loss(logits, labels_d, mask)
        with record_function("train_step.backward"):
            loss.backward()
        with record_function("train_step.dense_update"):
            opt_state = self.optimizer.update(params, opt_state)
        with record_function("train_step.metrics"):
            preds = preds.detach()
            p0 = preds if preds.dim() == 1 else preds[:, 0]
            l0 = labels_d if labels_d.dim() == 1 else labels_d[:, 0]
            auc_state = auc_update(auc_state, p0, l0, mask)
        with record_function("train_step.download"):
            demb = emb_d.grad.cpu().numpy()
        return params, opt_state, auc_state, demb, loss.detach(), preds

    @torch.inference_mode()
    def predict(self, params: nn.Module, emb, segment_ids, cvm_in,
                dense) -> torch.Tensor:
        """Scores of one batch (device tensors or host arrays)."""
        sparse = self._features(self._tensor(emb, np.float32),
                                self._tensor(segment_ids, np.int32),
                                self._tensor(cvm_in, np.float32))
        return torch.sigmoid(params(sparse,
                                    self._tensor(dense, np.float32)))
