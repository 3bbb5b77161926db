"""Train step, optimizer and train state for the port.

The port's own copy of ``dualvgr_tpu/train_lib.py`` in PyTorch idiom. The
recipe (reference train.py:85,158,179-180,341-349): Adam with global-norm
gradient clipping at 12, and the learning rate halved every 10 epochs,
keyed on the number of updates already applied.

One ``train_step`` is: the forward in training mode (dropout from the
state's generator, the classifier's batch statistics over the ``valid``
rows), CE + alpha * common + beta * HSIC, the backward, then the clip and
one Adam update. Three details follow optax, which the JAX package uses:

* the clip scales by ``max_norm / g_norm`` only when ``g_norm >= max_norm``
  (``torch.nn.utils.clip_grad_norm_`` would divide by ``g_norm + 1e-6``);
* the learning rate of an update is the schedule at the count of updates
  applied before it (optax's ``count``); with ``grad_accum = K`` that count
  is turned back into micro-steps, so decay lands on the same epochs;
* with ``grad_accum = K`` every K calls make one update from the MEAN of
  their K gradients (``optax.MultiSteps``), one clip and one Adam step.

Under data parallelism (a state placed by ``parallel.tp.place_state``)
the step computes what one process computes on the global batch, as the
JAX package's does over a sharded batch: each rank's loss is its rows'
share of the global loss (the means over the global batch's valid rows,
``ops/losses.py``), the gradients are summed over the data axis by
all-reduces that the backward launches bucket by bucket as it finishes
their gradients, as ``DistributedDataParallel`` does, so that the
communication overlaps the rest of the backward (``_GradBuckets`` in
``parallel/tp.py``; DDP's wrapper is not used, so that one path serves
whole parameters, TP shards and ZeRO-1 slices), the clip's norm is taken
after them (identical on every rank), the accumulation window averages
all-reduced gradients, and the metrics are the global batch's. Under ZeRO-1 Adam runs on this rank's
slices and the slices are gathered (``parallel/tp.py``).

The state is updated in place; ``train_step`` returns the metrics as 0-d
tensors on the model's device, so a loop need not wait for the card.
``pred_step`` is the eval forward with the argmax on the device (the JAX
package's ``jit_pred_step``), for validation.

On one CUDA card the micro-step is replayed as one CUDA graph, so that the
card, not the host issuing a thousand launches, sets the pace. A state
steps eagerly first (Adam's moments and the kernels' one-time set-up); from
its second step ``train_step`` captures ``forward_backward`` and
``apply_gradients`` once per batch key (``batch_key``: every batch of a run
has one, since the loader pads the last one to the batch size) and then
replays them: the batch copied into the graph's inputs, one launch, the
metrics cloned. Dropout draws from ``state.generator``, registered with the
graph, so a replay advances it as an eager step does; Adam is made
capturable, its counts and learning rate on the device (the host writes
the rate when the schedule changes it). A graph replays only while every
tensor it reads or updates in place is the one it captured, and is
captured again otherwise (a restore, ``adam.load_state_dict``). Every other
step runs eagerly (``eager_reason``): on the CPU, placed on a mesh, under
accumulation, or outside training mode.
"""

from __future__ import annotations

import operator
from dataclasses import dataclass, field

import torch

from dualvgr_tpu_torch.models.dualvgr import DualVGR
from dualvgr_tpu_torch.ops import COUNTED_KERNELS, launch_counts
from dualvgr_tpu_torch.ops.losses import dualvgr_total_loss
from dualvgr_tpu_torch.parallel.comm import all_reduce_
from dualvgr_tpu_torch.utils.trace import count, span


def make_lr_schedule(base_lr: float, steps_per_epoch: int, decay_epochs: int = 10):
    """lr = base * 0.5^(epoch // decay_epochs), epoch = step // steps_per_epoch."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return base_lr * 0.5 ** (epoch // decay_epochs)

    return schedule


# optax.adam's defaults, which the JAX package uses
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


@dataclass(frozen=True)
class Optimizer:
    """What ``make_optimizer`` describes: Adam, the global-norm clip, the
    schedule and the number of micro-steps per update. ``steps_per_epoch``
    counts micro-steps."""

    base_lr: float
    steps_per_epoch: int
    max_grad_norm: float = 12.0
    grad_accum: int = 1

    def lr(self, updates: int) -> float:
        """The learning rate of the update that follows ``updates`` applied ones."""
        return make_lr_schedule(self.base_lr, self.steps_per_epoch)(updates * self.grad_accum)


def make_optimizer(base_lr: float, steps_per_epoch: int, max_grad_norm: float = 12.0,
                   grad_accum: int = 1) -> Optimizer:
    """Adam + global-norm clip (+ gradient accumulation over ``grad_accum``
    micro-steps). The batch-coupled terms (batch-norm statistics, the HSIC
    Gram matrices) still see each micro-batch on its own, as in the JAX
    package."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    return Optimizer(base_lr, steps_per_epoch, max_grad_norm, grad_accum)


@dataclass
class TrainState:
    """The model (in training mode), its optimizer, the dropout generator and
    the counts: ``step`` micro-steps taken, ``updates`` Adam updates applied,
    ``mini_step`` micro-gradients waiting in ``acc_grads``. ``placement``
    (``parallel.tp.Placement``) says how it lies on a mesh; None in one
    process. ``graphs``: the captured steps by their key; ``lr_on_device``:
    the learning-rate tensor of a capturable Adam and the rate last written
    to it."""

    model: DualVGR
    optimizer: Optimizer
    adam: torch.optim.Adam
    generator: torch.Generator
    step: int = 0
    updates: int = 0
    mini_step: int = 0
    acc_grads: list[torch.Tensor] = field(default_factory=list)
    placement: object = None
    graphs: dict = field(default_factory=dict)
    lr_on_device: tuple | None = None


def create_train_state(model: DualVGR, optimizer: Optimizer, *, seed: int = 0) -> TrainState:
    """Put ``model`` in training mode and give it Adam and a dropout
    generator seeded ``seed`` on the model's device."""
    device = next(model.parameters()).device
    model.train()
    params = list(model.parameters())
    adam = torch.optim.Adam(params, lr=optimizer.lr(0), betas=ADAM_BETAS, eps=ADAM_EPS)
    acc = [torch.zeros_like(p) for p in params] if optimizer.grad_accum > 1 else []
    return TrainState(model, optimizer, adam, torch.Generator(device=device).manual_seed(seed),
                      acc_grads=acc)


def set_glove(state: TrainState, glove_matrix) -> TrainState:
    """Overwrite the question embedding with GloVe (reference train.py:75-79)."""
    weight = state.model.linguistic_input_unit.encoder_embed.weight
    glove = torch.as_tensor(glove_matrix, dtype=torch.float32)
    if tuple(glove.shape) != tuple(weight.shape):
        raise ValueError(f"GloVe matrix shape {tuple(glove.shape)} != embedding {tuple(weight.shape)}")
    with torch.no_grad():
        weight.copy_(glove)
    return state


def reset_grad_accum(state: TrainState) -> TrainState:
    """Drop a partly filled accumulation window (after a restore, which
    replays the interrupted epoch from its start); the update count the
    schedule runs on is kept."""
    for acc in state.acc_grads:
        acc.zero_()
    state.mini_step = 0
    return state


def _unpack(batch, device):
    """(app, motion, question, qlen, answers[, valid]) as tensors on ``device``;
    ``valid`` defaults to all ones."""
    if len(batch) not in (5, 6):
        raise ValueError(f"a batch is 5 or 6 arrays, got {len(batch)}")
    app, mot = (torch.as_tensor(a, dtype=torch.float32, device=device) for a in batch[:2])
    q, qlen = (torch.as_tensor(a, device=device) for a in batch[2:4])
    answers = torch.as_tensor(batch[4], device=device).long()
    if len(batch) == 6:
        valid = torch.as_tensor(batch[5], dtype=torch.float32, device=device)
    else:
        valid = torch.ones(answers.shape[0], dtype=torch.float32, device=device)
    return app, mot, q, qlen, answers, valid


def forward_backward(state: TrainState, batch, *, alpha: float, beta: float) -> dict:
    """The forward in training mode, the total loss and its backward: leaves
    the gradient in each parameter's ``.grad`` and returns the metrics
    ``{loss, ce, common, dependence, correct, count}``."""
    model = state.model
    with span("train.forward"):
        app, mot, q, qlen, answers, valid = _unpack(batch, next(model.parameters()).device)
        model.zero_grad(set_to_none=True)
        data = state.placement.data if state.placement is not None else None
        count = all_reduce_(valid.sum(), data) if data is not None else None
        out = model(app, mot, q, qlen, valid, generator=state.generator)
        total, aux = dualvgr_total_loss(
            out.logits, answers, out.aq_fusion, out.com_app, out.mq_fusion, out.com_motion,
            alpha=alpha, beta=beta, num_of_nodes=model.visual_input_unit.num_of_nodes, valid=valid,
            count=count,
        )
    with span("train.backward"):
        if state.placement is not None:
            state.placement.before_backward()
        total.backward()
    with torch.no_grad():
        correct = ((out.logits.argmax(dim=1) == answers) * valid).sum()
        metrics = torch.stack([total.detach(), aux["ce"].detach(), aux["common"].detach(),
                               aux["dependence"].detach(), correct.float()])
        if data is not None:  # each rank's share: the global batch's are their sums
            all_reduce_(metrics, data)
        loss, ce, common, dep, correct = metrics.unbind()
    return {
        "loss": loss, "ce": ce, "common": common, "dependence": dep, "correct": correct,
        "count": (count if count is not None else valid.sum()).to(torch.int32),
    }


@torch.no_grad()
def apply_gradients(state: TrainState) -> None:
    """Accumulate the gradients in ``.grad`` or, at the end of a window,
    clip them and take one Adam step at the schedule's learning rate."""
    with span("train.optimizer"):
        opt, pl = state.optimizer, state.placement
        with span("optimizer.clip"):
            params = [p.param for p in pl.params] if pl is not None else list(state.model.parameters())
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
            if pl is not None:
                pl.reduce_gradients(grads)
            state.step += 1
            if opt.grad_accum > 1:
                # running mean, as optax.MultiSteps accumulates
                for acc, g in zip(state.acc_grads, grads):
                    acc.add_((g - acc) / (state.mini_step + 1))
                state.mini_step += 1
                if state.mini_step < opt.grad_accum:
                    return
                grads = [acc.clone() for acc in state.acc_grads]
                reset_grad_accum(state)
            if pl is not None:
                g_norm = pl.grad_norm(grads)
            else:
                g_norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            clipped = g_norm >= opt.max_grad_norm
            for p, g in zip(params, grads):
                p.grad = torch.where(clipped, g / g_norm * opt.max_grad_norm, g)
        with span("optimizer.adam"):
            _write_lr(state)
            if pl is not None and pl.zero:
                pl.zero_step(state.adam)
            else:
                state.adam.step()
            state.updates += 1


def _write_lr(state: TrainState) -> None:
    """Sets Adam's learning rate to the schedule's for the next update. A
    capturable group keeps it in a float64 tensor on the device (divided
    there by the float64 bias correction, see ``_make_capturable``), which a
    graph reads: the host writes it only when the rate changes, and never
    while a step is being captured (``_graphed_step`` writes it first)."""
    lr = state.optimizer.lr(state.updates)
    for group in state.adam.param_groups:
        held = state.lr_on_device
        if not group["capturable"]:
            group["lr"] = lr
        elif held is None or held[0] is not group["lr"]:
            group["lr"] = torch.full((), lr, dtype=torch.float64, device=group["params"][0].device)
            state.lr_on_device = (group["lr"], lr)
        elif held[1] != lr:
            group["lr"].fill_(lr)
            state.lr_on_device = (group["lr"], lr)


def _make_capturable(adam: torch.optim.Adam, device: torch.device) -> None:
    """Adam as a CUDA graph can hold it: capturable, so that its counts and
    its learning rate (``_write_lr``) are read on the device, each count in
    float64, so that the bias corrections are taken in double precision as
    the host takes them for the plain kernel (from a float32 count they are
    0.3-1e-5 off in the first updates, in the fused kernel ~1e-6)."""
    for group in adam.param_groups:
        group["capturable"] = True
    for st in adam.state.values():
        if st["step"].dtype != torch.float64 or st["step"].device != device:
            st["step"] = st["step"].to(device=device, dtype=torch.float64)


def batch_key(batch) -> tuple:
    """The shapes and dtypes of ``batch``'s arrays or tensors: one captured
    step serves every batch with the same key, whatever its values."""
    return tuple((tuple(a.shape), str(a.dtype)) for a in batch)


def eager_reason(state: TrainState) -> str | None:
    """Why ``train_step`` takes this step eagerly, or None where a CUDA
    graph takes it: one process on a CUDA card, one micro-step per update,
    the model in training mode, and Adam with a state (so a state's first
    step is eager)."""
    model = state.model
    if state.placement is not None:
        return "placed on a mesh"
    if state.optimizer.grad_accum != 1:
        return "gradient accumulation"
    if not model.training:
        return "not in training mode"
    device = next(model.parameters()).device
    if device.type != "cuda":
        return f"on {device.type}"
    if not state.adam.state:
        return "no Adam state yet"
    return None


_METRICS = ("loss", "ce", "common", "dependence", "correct")


def _pack(metrics: dict) -> torch.Tensor:
    """The metrics as one (6,) fp32 tensor, ``count``'s int32 bits last."""
    return torch.stack([*(metrics[k] for k in _METRICS), metrics["count"].view(torch.float32)])


def _unpack_metrics(packed: torch.Tensor) -> dict:
    *values, n = packed.unbind()
    return {**dict(zip(_METRICS, values)), "count": n.view(torch.int32)}


def _held(state: TrainState) -> list:
    """What a captured step reads or updates in place outside its own
    memory, as the optimizer holds it: the dropout generator, the learning
    rate, each parameter and its Adam state tensors. A graph replays only
    while each is the object it captured (a restore copies into the
    parameters and buffers, and replaces Adam's tensors)."""
    st = state.adam.state
    out = [state.generator]
    for group in state.adam.param_groups:
        out.append(group["lr"])
        for p in group["params"]:
            s = st[p]
            out += (p, s["exp_avg"], s["exp_avg_sq"], s["step"])
    return out


class _StepGraph:
    """The single-process micro-step at one batch key as one CUDA graph.

    Capture runs ``forward_backward`` and ``apply_gradients`` once on
    static inputs under ``torch.cuda.graph``: nothing runs on the card, and
    the host's counts (``step``, ``updates``) move as in one eager step.
    ``replay`` copies a batch into the static inputs, launches the graph,
    adds the launches it holds to the kernels' counters and returns fresh
    clones of its metrics, so that a later replay leaves them as they were.
    """

    def __init__(self, state: TrainState, inputs: tuple, held: list, *, alpha: float, beta: float):
        self.held, self.params = held, list(state.model.parameters())
        self.inputs = tuple(torch.empty_like(t) for t in inputs)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(state.generator)
        before = launch_counts()
        # thread_local: the loader's producer pins memory while the step is captured
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.outputs = _pack(forward_backward(state, self.inputs, alpha=alpha, beta=beta))
            apply_gradients(state)
        # the kernels' counters count what the card ran: a replay adds the
        # launches the graph holds, and the capture ran none
        self.launches = tuple(a - b for a, b in zip(launch_counts(), before))
        for kernel, n in zip(COUNTED_KERNELS, before):
            kernel.launches = n
        self.grads = [p.grad for p in self.params]
        count("train.graph_captures")

    def holds(self, held: list) -> bool:
        return len(held) == len(self.held) and all(map(operator.is_, held, self.held))

    def replay(self, inputs: tuple) -> dict:
        for static, t in zip(self.inputs, inputs):
            static.copy_(t)
        self.graph.replay()
        for kernel, n in zip(COUNTED_KERNELS, self.launches):
            kernel.launches += n
        if self.params[0].grad is not self.grads[0]:  # an eager step or another graph ran since
            for p, g in zip(self.params, self.grads):
                p.grad = g
        count("train.graph_replays")
        return _unpack_metrics(self.outputs.clone())


def _graphed_step(state: TrainState, batch, *, alpha: float, beta: float) -> dict:
    """``train_step`` through the graph of the batch's key, captured first
    where there is none or it holds stale tensors."""
    model = state.model
    inputs = _unpack(batch, next(model.parameters()).device)
    key = (batch_key(inputs), alpha, beta, model.use_kernels, model.compute_dtype)
    _write_lr(state)
    graph = state.graphs.get(key)
    if graph is None or not graph.holds(_held(state)):
        _make_capturable(state.adam, inputs[0].device)
        _write_lr(state)
        held = _held(state)
        state.graphs = {k: g for k, g in state.graphs.items() if g.holds(held)}
        graph = state.graphs[key] = _StepGraph(state, inputs, held, alpha=alpha, beta=beta)
    else:
        state.step += 1
        state.updates += 1
    with span("train.graph_replay"):
        return graph.replay(inputs)


def train_step(state: TrainState, batch, *, alpha: float, beta: float) -> dict:
    """One micro-step: ``forward_backward`` then ``apply_gradients``, as one
    CUDA graph's replay where ``eager_reason`` finds none against it.

    ``batch`` = (app, motion, question, qlen, answers) or the same +
    (valid,), numpy arrays or tensors; ``valid`` (B,) float masks padded
    rows of a final partial batch. Returns the metrics
    ``{loss, ce, common, dependence, correct, count}``, fresh tensors every
    step.
    """
    if eager_reason(state) is None:
        return _graphed_step(state, batch, alpha=alpha, beta=beta)
    count("train.eager_steps")
    metrics = forward_backward(state, batch, alpha=alpha, beta=beta)
    apply_gradients(state)
    return metrics


def pred_step(state_or_model, batch) -> torch.Tensor:
    """The predicted answer ids (B,) on the model's device for ``batch`` =
    (app, motion, question, qlen), numpy arrays or tensors.

    Runs the eval-mode forward under ``torch.no_grad()`` and takes the
    argmax on the device, so only B ints need cross to the host; then puts
    the model back in the mode it found it in (a train state holds its
    model in training mode, and validating in it would run dropout and
    batch statistics)."""
    model = state_or_model.model if isinstance(state_or_model, TrainState) else state_or_model
    device = next(model.parameters()).device
    app, mot, q, qlen = (torch.as_tensor(a, device=device) for a in batch)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return model(app, mot, q, qlen).logits.argmax(dim=1)
    finally:
        model.train(was_training)
