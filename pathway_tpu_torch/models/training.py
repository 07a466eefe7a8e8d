"""Contrastive fine-tuning of the sentence encoder over a device mesh.

Port of ``pathway_tpu/models/training.py``: the symmetric in-batch-negatives
loss (InfoNCE, the recipe all-MiniLM-L6-v2 was trained with) and
``ContrastiveTrainer``, which owns the parameters and the AdamW state and
takes one step per call.

The reference compiles one GSPMD step: the batch sharded over the mesh's
``data`` axis, the heads and FFN columns over ``model``. The port writes
that step out over a :class:`~pathway_tpu_torch.parallel.sharding.DeviceMesh`:

* each row of the mesh holds a replica; the batch is split over the rows;
* in a row of one device the replica is a plain ``TextEncoder``; over
  several devices ``param_sharding`` places each parameter: the qkv
  projection's heads (split inside each of q, k and v), the ``mlp_in``
  rows and the ``out`` / ``mlp_out`` columns on their model device, every
  other parameter on the row's first device. Attention (kernel B3 on a
  card) runs once per model shard on its ``num_heads / tp`` heads, and the
  partial products of ``out`` and ``mlp_out`` are summed on the row's first
  device;
* the embeddings of every row gather on the mesh's first device for one
  global loss, as GSPMD computes it; the replicas' gradients are summed
  into the first replica, whose AdamW steps, and the other replicas copy
  its parameters, so they stay identical.

Attention's backward recomputes through the plain chain
(``ops/fused_attention``), as the reference's recomputes through XLA; the
projections and the FFN are ``F.linear``, as the reference leaves them to
XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import as_current
from ..ops.fused_attention import attention
from ..parallel.sharding import MODEL_AXIS, DeviceMesh, Placement, data_sharding, make_mesh, param_sharding
from .encoder import EncoderConfig, TextEncoder, _norm, init_params, param_logical_axes, pool

# optax.adamw's defaults: the reference's optimizer, every parameter decayed
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
WEIGHT_DECAY = 1e-4


def info_nce_loss(emb_a: torch.Tensor, emb_b: torch.Tensor, temperature: float = 0.05) -> torch.Tensor:
    """Symmetric in-batch-negatives contrastive loss on normalized embeddings."""
    logits = emb_a @ emb_b.T / temperature  # [B, B]
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)) / 2


def _qkv_groups(name: str) -> int:
    """Column groups a parameter is split inside: the fused qkv projection
    is q | k | v, heads minor within each, so each model shard takes its
    heads from each of the three."""
    return 3 if name.endswith("attention.qkv.weight") else 1


class _Replica:
    """One row of the mesh: the encoder's parameters on the row's devices."""

    def __init__(self, cfg: EncoderConfig, row: tuple, placements: dict[str, Placement]):
        self.cfg, self.row, self.placements = cfg, row, placements
        self.tp = len(row)
        self.module = None
        self.params: dict[str, list[torch.Tensor]] = {}
        if self.tp == 1:
            with torch.device("meta"):
                self.module = TextEncoder(cfg)
            self.module.to_empty(device=row[0])

    def load(self, state_dict: dict) -> None:
        if self.module is not None:
            with torch.no_grad():
                self.module.load_state_dict(state_dict)
            return
        for name, placement in self.placements.items():
            t = state_dict[name].detach().float()
            pieces = placement.split(t, groups=_qkv_groups(name))
            devs = self.row if len(pieces) == self.tp else self.row[:1]
            self.params[name] = [p.to(dev).contiguous().requires_grad_(True) for p, dev in zip(pieces, devs)]

    def leaves(self) -> list[torch.Tensor]:
        """Every parameter tensor, in one order for every replica."""
        if self.module is not None:
            return list(self.module.parameters())
        return [t for name in self.placements for t in self.params[name]]

    def gather(self, value) -> dict[str, torch.Tensor]:
        """``value(parameter)`` of every parameter, joined into the
        TextEncoder layout on the row's first device."""
        if self.module is not None:
            return {name: value(t) for name, t in self.module.named_parameters()}
        return {
            name: self.placements[name].join([value(t).to(self.row[0]) for t in ts], groups=_qkv_groups(name))
            for name, ts in self.params.items()
        }

    def __call__(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.module is not None:
            with as_current(self.row[0]):
                return self.module(ids, mask)
        return self._sharded_forward(ids, mask)

    def _sharded_forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """``TextEncoder.forward`` with each layer's heads and FFN columns
        on the row's model devices."""
        cfg, devs, p = self.cfg, self.row, self.params
        dt, eps, d0 = cfg.dtype, cfg.layer_norm_eps, self.row[0]
        one = lambda name: p[name][0]  # noqa: E731
        ids = ids.long()
        x = F.embedding(ids, one("tok_embed.weight")).to(dt) + one("pos_embed.weight")[: ids.shape[1]][None].to(dt)
        if cfg.type_vocab_size:
            x = x + F.embedding(torch.zeros_like(ids), one("type_embed.weight")).to(dt)
        x = _norm(x, one("ln_embed.weight"), one("ln_embed.bias"), eps, dt)
        mask = mask.bool()
        masks = [mask.to(dev) for dev in devs]
        heads = cfg.num_heads // self.tp
        for i in range(cfg.num_layers):
            pre = f"layers.{i}."
            qkv_b = self.placements[pre + "attention.qkv.weight"].split(one(pre + "attention.qkv.bias"), groups=3)
            in_b = self.placements[pre + "mlp_in.weight"].split(one(pre + "mlp_in.bias"))
            parts = []
            for j, dev in enumerate(devs):
                with as_current(dev):
                    xj = x.to(dev)
                    qkv = F.linear(xj, p[pre + "attention.qkv.weight"][j].to(dt), qkv_b[j].to(dev).to(dt))
                    ctx = attention(qkv.contiguous(), masks[j], n_heads=heads, impl=cfg.attention_impl)
                    parts.append(F.linear(ctx, p[pre + "attention.out.weight"][j].to(dt)))
            a = _sum_parts(parts, d0, one(pre + "attention.out.bias"), dt)
            x = _norm(x + a, one(pre + "ln_att.weight"), one(pre + "ln_att.bias"), eps, dt)
            parts = []
            for j, dev in enumerate(devs):
                with as_current(dev):
                    m = F.linear(x.to(dev), p[pre + "mlp_in.weight"][j].to(dt), in_b[j].to(dev).to(dt))
                    m = F.gelu(m, approximate="tanh")
                    parts.append(F.linear(m, p[pre + "mlp_out.weight"][j].to(dt)))
            m = _sum_parts(parts, d0, one(pre + "mlp_out.bias"), dt)
            x = _norm(x + m, one(pre + "ln_mlp.weight"), one(pre + "ln_mlp.bias"), eps, dt)
        return pool(x, mask, cfg)


def _grad(t: torch.Tensor) -> torch.Tensor:
    return t.grad.detach() if t.grad is not None else torch.zeros_like(t)


def _sum_parts(parts: list, device, bias: torch.Tensor, dt) -> torch.Tensor:
    """The model shards' partial products summed in f32 on ``device``, plus
    the bias, rounded once to the working dtype."""
    total = parts[0].to(device).float()
    for part in parts[1:]:
        total = total + part.to(device).float()
    return (total + bias.float()).to(dt)


class ContrastiveTrainer:
    """Owns the mesh-placed parameters and the AdamW state; :meth:`step`
    takes one training step.

    ``mesh=None`` means ``make_mesh()``: every visible card, raising without
    one; the trainer runs on the CPU only on a mesh of CPU devices. The
    parameters start from the port's seeded ``init_params(cfg, seed)``;
    :meth:`load_state_dict` replaces them (a TextEncoder state dict, e.g.
    the reference's through ``weights.from_jax_params``) and resets the
    optimizer."""

    def __init__(
        self,
        config: EncoderConfig | None = None,
        mesh: DeviceMesh | None = None,
        learning_rate: float = 2e-5,
        seed: int = 0,
    ):
        self.cfg = config or EncoderConfig.minilm_l6()
        self.mesh = mesh if mesh is not None else make_mesh()
        self.learning_rate = learning_rate
        tp = self.mesh.shape[MODEL_AXIS]
        if self.cfg.num_heads % tp or self.cfg.intermediate_size % tp:
            raise ValueError(
                f"a model axis of {tp} must divide num_heads {self.cfg.num_heads} and intermediate_size "
                f"{self.cfg.intermediate_size}; make_mesh(heads=) keeps the split on head boundaries"
            )
        with torch.device("meta"):
            logical = param_logical_axes(TextEncoder(self.cfg), self.cfg)
        self.p_sharding = param_sharding(self.mesh, logical)
        self.d_sharding = data_sharding(self.mesh)
        self.device = self.mesh.devices[0][0]
        self._replicas = [_Replica(self.cfg, row, self.p_sharding) for row in self.mesh.devices]
        self.load_state_dict(init_params(self.cfg, seed))

    def load_state_dict(self, state_dict: dict) -> None:
        """Place a TextEncoder state dict on every replica and start a fresh
        optimizer state."""
        for rep in self._replicas:
            rep.load(state_dict)
        self.opt = torch.optim.AdamW(
            self._replicas[0].leaves(), lr=self.learning_rate, betas=ADAM_BETAS, eps=ADAM_EPS,
            weight_decay=WEIGHT_DECAY,
        )

    def state_dict(self) -> dict[str, torch.Tensor]:
        """The current parameters in the TextEncoder layout, on the mesh's first device."""
        return self._replicas[0].gather(torch.Tensor.detach)

    def _batch(self, ids, mask) -> list[tuple[torch.Tensor, torch.Tensor]]:
        split = self.d_sharding.split
        rows = zip(split(torch.as_tensor(ids).long()), split(torch.as_tensor(mask).bool()))
        return [(i.to(rep.row[0]), m.to(rep.row[0])) for rep, (i, m) in zip(self._replicas, rows)]

    def loss(self, ids_a, mask_a, ids_b, mask_b) -> torch.Tensor:
        """The global InfoNCE loss of the pairs (a_i, b_i), with its graph:
        each row's replica embeds its part of both towers, and the
        embeddings gather on the mesh's first device."""
        ea, eb = [], []
        for rep, (ia, ma), (ib, mb) in zip(self._replicas, self._batch(ids_a, mask_a), self._batch(ids_b, mask_b)):
            ea.append(rep(ia, ma).to(self.device))
            eb.append(rep(ib, mb).to(self.device))
        return info_nce_loss(torch.cat(ea), torch.cat(eb))

    def backward(self, loss: torch.Tensor) -> None:
        """Gradients of ``loss`` summed over the replicas into the first's."""
        self.opt.zero_grad(set_to_none=True)
        for rep in self._replicas[1:]:
            for t in rep.leaves():
                t.grad = None
        loss.backward()
        first = self._replicas[0].leaves()
        with torch.no_grad():
            for rep in self._replicas[1:]:
                for t0, t in zip(first, rep.leaves()):
                    if t.grad is not None:
                        g = t.grad.to(t0.device)
                        t0.grad = g if t0.grad is None else t0.grad.add_(g)

    def apply_gradients(self) -> None:
        """One AdamW update of the first replica; the others copy it."""
        self.opt.step()
        first = self._replicas[0].leaves()
        with torch.no_grad():
            for rep in self._replicas[1:]:
                for t0, t in zip(first, rep.leaves()):
                    t.copy_(t0)

    def value_and_grad(self, ids_a, mask_a, ids_b, mask_b) -> tuple[float, dict[str, torch.Tensor]]:
        """(loss, gradients in the TextEncoder layout) at the current
        parameters, which it leaves unchanged."""
        loss = self.loss(ids_a, mask_a, ids_b, mask_b)
        self.backward(loss)
        grads = self._replicas[0].gather(_grad)
        self.opt.zero_grad(set_to_none=True)
        return float(loss.detach()), grads

    def step(self, ids_a, mask_a, ids_b, mask_b) -> float:
        """One step on the pairs (ids_a[i], ids_b[i]) (numpy arrays or
        tensors, [B, S] ids and masks; B divisible by the data axis).
        Returns the loss at the parameters before the update, as the
        reference's ``value_and_grad`` does."""
        loss = self.loss(ids_a, mask_a, ids_b, mask_b)
        self.backward(loss)
        self.apply_gradients()
        return float(loss.detach())

