"""The step's forward half and the pieces of its training half
(counterpart of ``paddlebox_tpu/trainer/train_step.py``).

Forward: ``emb[Npad, D]``, ``segment_ids[Npad]``, ``cvm_in[B, 2]``,
``dense[B, Dd]`` -> seqpool+CVM -> model -> sigmoid. The module passed to
``predict`` holds the weights (the role of the reference's params pytree).

Training pieces, used by ``trainer.fused_step.FusedTrainStep``:
``make_dense_optimizer`` (optax's math for adam, adamw, sgd and adagrad,
updating a module's parameters in place) and ``masked_bce_loss`` (the
reference's ``_loss_fn``). The host-table training step (``TrainStep``'s
``__call__`` over ``ps/table.py`` push) is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from paddlebox_tpu_torch.config import TableConfig, TrainerConfig
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm

# optax's defaults: adam(b1, b2, eps), adagrad(initial accumulator, eps)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
ADAGRAD_INIT, ADAGRAD_EPS = 0.1, 1e-7


def full_float32_matmuls() -> None:
    """The model's matmuls run in full float32, as in the JAX reference:
    TF32 keeps about three decimal digits. The flags are process-wide."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class DenseOptimizer:
    """A dense optimizer in optax's math. ``init(model)`` makes the state;
    ``update(model, state)`` applies one step from the parameters' ``.grad``
    (a parameter without a grad counts as a zero grad), in place, and
    returns the state; it reads nothing back to the host. Note that
    optax's adagrad starts its accumulator at 0.1 and adds eps 1e-7 inside
    the square root, where ``torch.optim.Adagrad`` starts at 0 and adds
    1e-10 outside it."""

    def __init__(self, name: str, learning_rate: float,
                 weight_decay: float = 0.0):
        self.name = name
        self.lr = learning_rate
        self.weight_decay = weight_decay

    def init(self, model: nn.Module) -> Dict[str, Any]:
        params = list(model.parameters())
        if self.name in ("adam", "adamw"):
            # optax's ScaleByAdamState.count: an int32 on the device, so
            # that a captured step (trainer/step_graph.py) advances it
            dev = params[0].device if params else None
            return {"count": torch.zeros((), dtype=torch.int32, device=dev),
                    "mu": [torch.zeros_like(p) for p in params],
                    "nu": [torch.zeros_like(p) for p in params]}
        if self.name == "adagrad":
            return {"sum_of_squares": [torch.full_like(p, ADAGRAD_INIT)
                                       for p in params]}
        return {}

    @torch.no_grad()
    def update(self, model: nn.Module,
               state: Dict[str, Any]) -> Dict[str, Any]:
        params: List[torch.Tensor] = list(model.parameters())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if self.name in ("adam", "adamw"):
            count = state["count"]
            count.add_(1)
            # optax's bias corrections, 1 - b ** count in f32, on the device
            t = count.float()
            bc1 = 1 - ADAM_B1 ** t
            bc2 = 1 - ADAM_B2 ** t
            for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
                mu.copy_((1 - ADAM_B1) * g + ADAM_B1 * mu)
                nu.copy_((1 - ADAM_B2) * (g * g) + ADAM_B2 * nu)
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
                if self.name == "adamw":
                    u = u + self.weight_decay * p
                p.add_(-self.lr * u)
        elif self.name == "adagrad":
            for p, g, sos in zip(params, grads, state["sum_of_squares"]):
                sos.copy_(g * g + sos)
                inv = torch.where(sos > 0, torch.rsqrt(sos + ADAGRAD_EPS),
                                  sos.new_zeros(()))
                p.add_(-self.lr * (inv * g))
        else:
            for p, g in zip(params, grads):
                p.add_(-self.lr * g)
        return state


def make_dense_optimizer(conf: TrainerConfig) -> DenseOptimizer:
    """The dense-tower optimizer of ``conf``: adam, adamw, sgd or adagrad.
    lars, lamb and gradient merging are not ported yet."""
    name = conf.dense_optimizer
    if name in ("lars", "lamb"):
        raise NotImplementedError(
            f"dense optimizer {name!r} is not ported yet (ROADMAP A.2: "
            "lars, lamb, MultiSteps, recompute)")
    if name not in ("adam", "adamw", "sgd", "adagrad"):
        raise ValueError(f"unknown dense optimizer {name!r}")
    if conf.grad_merge_steps > 1:
        raise NotImplementedError(
            "grad_merge_steps > 1 (optax.MultiSteps) is not ported yet "
            "(ROADMAP A.2: lars, lamb, MultiSteps, recompute)")
    return DenseOptimizer(name, conf.dense_learning_rate,
                          conf.dense_weight_decay)


def sigmoid_binary_cross_entropy(logits: torch.Tensor,
                                 labels: torch.Tensor) -> torch.Tensor:
    """optax's form: ``-y log(sigmoid(x)) - (1 - y) log(sigmoid(-x))``."""
    labels = labels.to(logits.dtype)
    return -labels * F.logsigmoid(logits) - \
        (1.0 - labels) * F.logsigmoid(-logits)


def masked_bce_loss(logits: torch.Tensor, labels: torch.Tensor,
                    row_mask: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``sum(losses * mask) / max(sum(mask), 1)`` and the predictions."""
    if logits.dim() == 1 and labels.dim() == 2:
        labels = labels[:, 0]
    mask = row_mask if logits.dim() == 1 else row_mask[:, None]
    losses = sigmoid_binary_cross_entropy(logits, labels) * mask
    loss = losses.sum() / torch.clamp(mask.sum(), min=1.0)
    return loss, torch.sigmoid(logits)


class TrainStep:
    def __init__(self, table_conf: TableConfig, batch_size: int,
                 num_slots: int, dense_dim: int = 0, use_cvm: bool = True):
        full_float32_matmuls()
        self.table_conf = table_conf
        self.batch_size = batch_size
        self.num_slots = num_slots
        self.dense_dim = dense_dim
        self.use_cvm = use_cvm

    @property
    def sparse_width(self) -> int:
        """Per-slot width of the pooled features the model sees (the
        reference's ``TrainStep.init`` shape)."""
        D = self.table_conf.pull_dim
        return D if self.use_cvm else D - 2

    def _features(self, emb: torch.Tensor, segment_ids: torch.Tensor,
                  cvm_in: torch.Tensor) -> torch.Tensor:
        return fused_seqpool_cvm(
            emb, segment_ids, cvm_in, self.batch_size, self.num_slots,
            self.use_cvm)

    @torch.inference_mode()
    def predict(self, model: nn.Module, emb: torch.Tensor,
                segment_ids: torch.Tensor, cvm_in: torch.Tensor,
                dense: torch.Tensor) -> torch.Tensor:
        sparse = self._features(emb, segment_ids, cvm_in)
        return torch.sigmoid(model(sparse, dense))
