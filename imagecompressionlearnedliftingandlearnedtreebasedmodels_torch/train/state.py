"""Training state: optimizer, train and eval steps, host-side controllers.

The entry points of the port (each turns TF32 off: ``config.full_fp32``).
:func:`make_eval_step` serves (hard rounding,
bits from the likelihoods, ``xhat`` clipped to [-0.5, 0.5], then
``rd_loss3``). :func:`make_train_step` takes one optimizer step on the
noise-quantized surrogate. :func:`make_chained_train_step` takes
``cfg.steps_per_call`` of them in one call, as the JAX package's chained
step does in one dispatch: on a card one replay of a CUDA graph that holds
the k whole steps (:class:`GraphChain`), on the CPU k eager steps
(:class:`PlainChain`). The state lives where PyTorch keeps it: in the
model's parameters and the optimizer. The plateau scheduler and the
D-only -> R+lambda*D loss switch are small host-side controllers that feed
scalars (learning rate, rate weight) into the step, as in the JAX package's
``train/state.py``.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import time
from types import SimpleNamespace
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import Config, full_fp32, resolve_device
from ..ops import color, conv1x1g, conv3x3_halo, conv_v2, lift97
from ..utils.profiling import COUNTERS, device_phase, record_phases, span
from .loss import RDLossOutput, rd_loss3


def apply_color_forward(cfg: Config, model: nn.Module, x: torch.Tensor,
                        training: bool = False, generator=None):
    """Color policy + model forward; x is NCHW RGB in [0,1].

    Returns the shifted ``(x', xhat')`` in [-0.5, 0.5], the info tensors and
    the aux loss. ``training`` selects noise quantization, drawn from
    ``generator``.
    """
    if cfg.clrch == 3:
        xs = x - 0.5
        xhat, info_xe, info_xo, aux = model(xs, training, generator)
        return xs, xhat, info_xe, info_xo, aux
    with span("color"):
        y = color.shift_ycbcr(color.rgb_to_ycbcr(x))
    yhat, info_xe, info_xo, aux = model(y, training, generator)
    with span("color"):
        xhat = color.ycbcr_to_rgb(color.unshift_ycbcr(yhat))
    return x - 0.5, xhat - 0.5, info_xe, info_xo, aux


def make_optimizer(cfg: Config, model: nn.Module, capturable: bool = False
                   ) -> torch.optim.Adam:
    """Adam with its defaults (betas 0.9/0.999, eps 1e-8: ``optax.adam``'s
    too). The learning rate is adjustable at run time: the train steps write
    the plateau scheduler's current rate with :func:`set_lr`.

    ``capturable`` gives the form a CUDA graph can hold (the chained step on
    a card): Adam's step counts live on the parameters' device, and the
    learning rate is a float32 tensor there that :func:`set_lr` overwrites
    in place, so that every replay reads the current rate. Make it after the
    model is on its device. Checkpoints move between the two forms through
    :func:`load_optimizer_state`."""
    if not capturable:
        return torch.optim.Adam(model.parameters(), lr=cfg.learning_rate)
    dev = next(model.parameters()).device
    lr = torch.tensor(cfg.learning_rate, dtype=torch.float32, device=dev)
    return torch.optim.Adam(model.parameters(), lr=lr, capturable=True)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Write ``lr`` into every param group: in place into a capturable
    optimizer's device tensor, as a float otherwise."""
    for group in optimizer.param_groups:
        _set_group_lr(group, float(lr))


def _set_group_lr(group: dict, lr: float) -> None:
    if isinstance(group["lr"], torch.Tensor):
        group["lr"].fill_(lr)
    else:
        group["lr"] = lr


def load_optimizer_state(optimizer: torch.optim.Optimizer,
                         state_dict: dict) -> None:
    """Load an Adam state dict written by either form of
    :func:`make_optimizer` into ``optimizer``, which keeps its own form: its
    ``capturable`` flag, its learning-rate object (a device tensor given the
    saved rate in place, or a float), and each step count where that form
    keeps it (the parameter's device when capturable, the CPU otherwise)."""
    lrs, groups, capturable = [], [], {}
    for mine, saved in zip(optimizer.param_groups,
                           state_dict["param_groups"]):
        lrs.append((mine["lr"], float(saved["lr"])))
        groups.append(dict(saved, capturable=mine["capturable"]))
        capturable.update((i, mine["capturable"]) for i in saved["params"])
    state = {}
    for i, st in state_dict["state"].items():
        st = dict(st)
        if not capturable.get(i, False) and "step" in st:
            st["step"] = torch.tensor(float(st["step"]), dtype=torch.float32)
        state[i] = st
    optimizer.load_state_dict({"state": state, "param_groups": groups})
    # load_state_dict deep-copies the groups: give each its own rate object
    # back, which a captured graph reads
    for group, (obj, value) in zip(optimizer.param_groups, lrs):
        group["lr"] = obj
        _set_group_lr(group, value)


def _train_body(cfg: Config, model: nn.Module,
                optimizer: torch.optim.Optimizer) -> Callable:
    """``body(x, generator, rate_weight, lam) -> (RDLossOutput, aux)``: one
    optimizer step on the device batch ``x`` (NCHW RGB in [0, 1]), at the
    learning rate already in ``optimizer``. ``rate_weight`` and ``lam`` may
    be floats or device scalars. The ``grad_acc_iters`` quirk of the
    original (loss divided by the divisor but the optimizer stepped every
    iteration) is reproduced by the 1/k loss scale; the aux loss is added
    to the loss.

    The step's phases are the spans ``train.forward`` (the color policy,
    the model, the loss), ``train.backward`` and ``train.optimizer`` (the
    gradients' reset, which launches nothing, and Adam's update); inside a
    graph's recording the last three are timed on the device
    (``utils/profiling.py::device_phase``)."""
    loss_scale = 1.0 / max(cfg.grad_acc_iters, 1)

    def body(x, generator, rate_weight, lam):
        model.train()
        with span("train.optimizer"):
            optimizer.zero_grad(set_to_none=True)
        with device_phase("train.forward"):
            xs, xhat, info_xe, info_xo, aux = apply_color_forward(
                cfg, model, x, True, generator)
            out = rd_loss3(xs, xhat, info_xe, info_xo, lam, rate_weight)
        with device_phase("train.backward"):
            ((out.loss + aux) * loss_scale).backward()
        with device_phase("train.optimizer"):
            optimizer.step()
        return out, aux

    return body


def make_train_step(cfg: Config, model: nn.Module,
                    optimizer: torch.optim.Optimizer, device=None
                    ) -> Callable[..., Tuple[RDLossOutput, torch.Tensor]]:
    """Move ``model`` to ``device`` (CUDA unless the caller passes another;
    raises when none is available) and return
    ``train_step(batch, generator, lr, rate_weight, lam=None) ->
    (RDLossOutput, aux)``: one optimizer step, in place.

    ``batch`` is NCHW RGB in [0, 1]; ``generator`` gives the quantization
    noise; ``rate_weight`` (0.0 or 1.0) implements the loss switch; ``lr``
    is the plateau scheduler's current rate; ``lam`` defaults to
    ``cfg.lambda_`` and is a runtime value. The returned terms are
    detached.
    """
    dev = resolve_device(device)
    full_fp32()
    model.to(dev)
    body = _train_body(cfg, model, optimizer)

    def train_step(batch: torch.Tensor, generator: torch.Generator, lr: float,
                   rate_weight: float, lam: Optional[float] = None):
        if lam is None:
            lam = cfg.lambda_
        set_lr(optimizer, lr)
        out, aux = body(batch.to(dev, torch.float32), generator, rate_weight,
                        lam)
        return RDLossOutput(*(t.detach() for t in out)), aux.detach()

    return train_step


# --- steps_per_call: k optimizer steps in one call -------------------------

# uint8 -> float32 in [0, 1] exactly as the loader converts on the host
# (``astype(float32) / 255``): indexing this table gives the same bits on any
# device, where a division on the card may round otherwise (PyTorch's CUDA
# division by a scalar multiplies by its reciprocal)
_UNIT_TABLE = np.arange(256, dtype=np.uint8).astype(np.float32) / 255.0


@functools.lru_cache(maxsize=16)
def _unit_table(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_UNIT_TABLE).to(device)


def unit_float(x: torch.Tensor) -> torch.Tensor:
    """A uint8 batch as float32 in [0, 1], bit for bit the loader's
    conversion, on ``x``'s device; a float batch as it is."""
    if x.dtype != torch.uint8:
        return x.float()
    table = _unit_table(x.device)
    return table.index_select(0, x.reshape(-1).int()).view(x.shape)


def _launch_counters():
    """(module, attribute) of every hand-written kernel's launch count."""
    return ((conv3x3_halo, "launches"), (conv3x3_halo, "launches_dx"),
            (conv_v2, "launches"), (conv_v2, "launches_dx"),
            (lift97, "launches_lift"), (lift97, "launches_ilift"),
            (conv1x1g, "launches"), (conv1x1g, "launches_dx"))


def _add_launches(counts) -> None:
    for (mod, attr), n in zip(_launch_counters(), counts):
        setattr(mod, attr, getattr(mod, attr) + n)


def _host_batches(batches, k: int) -> torch.Tensor:
    """The loader's chunk ``(k, B, P, P, 3)`` (numpy or tensor, uint8 or
    float in [0, 1]) as a tensor, checked."""
    x = torch.as_tensor(batches)
    if x.dim() != 5 or x.shape[0] != k or x.shape[-1] != 3 \
            or x.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"a chained step takes ({k}, B, P, P, 3) uint8 or "
                         f"float32 batches, got {tuple(x.shape)} {x.dtype}")
    return x


def _row(out) -> torch.Tensor:
    return torch.stack([t.detach().float().reshape(()) for t in out[:4]])


class PlainChain:
    """``chained_step(batches, generator, lr, rate_weight, lam=None) ->
    Tensor (k, 4)``: k eager steps of ``body`` one after another, each on its
    batch of the chunk, at one (lr, rate_weight, lam); the rows are (loss,
    mse, rate1, rate2). ``take`` cuts this rank's share out of the chunk
    (the whole of it on one device).

    A call is the span ``chain.call`` (its ``req`` the call's index) around
    ``chain.scalars``, each step's ``chain.upload`` and body, and
    ``chain.rows``."""

    form = "plain"

    def __init__(self, k: int, lam: float, body: Callable,
                 optimizer: torch.optim.Optimizer, device, take=None):
        self.k, self.lam, self.body = k, lam, body
        self.optimizer, self.device = optimizer, torch.device(device)
        self.take = take or (lambda x: x)
        self.calls = itertools.count()

    def __call__(self, batches, generator, lr: float, rate_weight: float,
                 lam: Optional[float] = None) -> torch.Tensor:
        with span("chain.call", next(self.calls)):
            return self._call(batches, generator, lr, rate_weight, lam)

    def _call(self, batches, generator, lr, rate_weight, lam):
        lam = self.lam if lam is None else lam
        x = self.take(_host_batches(batches, self.k))
        with span("chain.scalars"):
            set_lr(self.optimizer, lr)
        rows = []
        for i in range(self.k):
            with span("chain.upload"):
                xi = unit_float(x[i].to(self.device)).permute(0, 3, 1, 2)
            rows.append(_row(self.body(xi, generator, rate_weight, lam)[0]))
        with span("chain.rows"):
            return torch.stack(rows)


class GraphChain(PlainChain):
    """The chained step on a card: one CUDA graph that holds k whole steps
    (forward, backward, the gradients' all-reduce on a NCCL mesh, Adam),
    captured at the first call for each chunk shape and replayed once per
    chunk. Same call and rows as :class:`PlainChain`, step for step the
    same results.

    The graph reads everything that changes between chunks from static
    device memory: the chunk (uint8, filled by one pinned non-blocking
    copy), its conversion to floats, the learning rate (the capturable
    optimizer's tensor), ``rate_weight`` and ``lam`` (device scalars), the
    noise generator's seed and offset (registered with the graph, so each
    replay draws new noise), and it writes the (k, 4) rows into a static
    tensor, read back once per chunk by the caller.

    Capture needs a warm-up: two eager steps on a side stream build the
    kernels (nvcc at first use) and the libraries' plans and make Adam's
    state; the parameters, buffers, Adam state and generator are put back as
    they were after it, so the first replay is the first step. A capture
    that fails raises. The kernels' launch counters count the graph's
    launches once per replay (the capture itself runs nothing). A graph
    whose parameters or optimizer state have moved since its capture (a
    state dict loaded into new tensors) is captured again.

    A call is the span ``chain.call`` around ``chain.upload`` (the wait on
    the last copy out of the pinned buffer included), ``chain.scalars``,
    ``chain.replay`` and ``chain.rows``. The body's timed phases are
    recorded into the graph as timing events; a replay launched while a
    profiler records hands them to ``utils/profiling.py::COUNTERS``, which
    reads them once they have completed, and where the capture's seconds
    are kept."""

    form = "graph"
    WARMUP_STEPS = 2

    def __init__(self, k, lam, body, optimizer, device, take=None,
                 model: Optional[nn.Module] = None):
        super().__init__(k, lam, body, optimizer, device, take)
        if self.device.type != "cuda":
            raise ValueError("a graph-chained step runs on a CUDA device")
        for group in optimizer.param_groups:
            if not group["capturable"] or not isinstance(group["lr"],
                                                         torch.Tensor):
                raise ValueError("a graph-chained step needs "
                                 "make_optimizer(..., capturable=True)")
        self.model = model
        self._graphs = {}
        self.replays = 0

    def _state_tensors(self):
        ts = [g["lr"] for g in self.optimizer.param_groups]
        if self.model is not None:
            ts += list(self.model.parameters()) + list(self.model.buffers())
        for st in self.optimizer.state.values():
            ts += [v for v in st.values() if isinstance(v, torch.Tensor)]
        return ts

    def _fingerprint(self):
        return tuple(t.data_ptr() for t in self._state_tensors())

    def _call(self, batches, generator, lr, rate_weight, lam):
        # the last replay's events record again in this one: read them now
        COUNTERS.settle()
        lam = self.lam if lam is None else lam
        x = self.take(_host_batches(batches, self.k))
        key = (tuple(x.shape), x.dtype)
        cap = self._graphs.get(key)
        if cap is not None and cap.fingerprint != self._fingerprint():
            self._graphs.clear()
            cap = None
        if cap is None:
            cap = self._graphs[key] = self._capture(x, generator, lr,
                                                    rate_weight, lam)
        elif generator is not cap.generator:
            raise ValueError("a graph-chained step draws its noise from the "
                             "generator it was captured with")
        self._upload(cap, x)
        self._scalars(cap, lr, rate_weight, lam)
        with span("chain.replay"):
            cap.graph.replay()
            _add_launches(cap.launches)
            self.replays += 1
        COUNTERS.replayed(cap.phases, self.k)
        with span("chain.rows"):
            return cap.rows.clone()

    @property
    def captured(self):
        """Per chunk shape: the capture's seconds (in all, the eager
        warm-up's, the recording's with the graph's instantiation) and the
        graph's kernel launches a replay, by counter, as
        ``utils/profiling.py::COUNTERS`` keeps them."""
        return {key: dict(cap.stats) for key, cap in self._graphs.items()}

    def _upload(self, cap, x: torch.Tensor) -> None:
        with span("chain.upload"):
            # the last copy out of the pinned buffer
            cap.copied.synchronize()
            cap.pinned.copy_(x)
            cap.static_in.copy_(cap.pinned, non_blocking=True)
            cap.copied.record()

    def _scalars(self, cap, lr, rate_weight, lam) -> None:
        with span("chain.scalars"):
            set_lr(self.optimizer, lr)
            cap.rate_weight.fill_(float(rate_weight))
            cap.lam.fill_(float(lam))

    def _steps(self, cap, n: int, generator) -> None:
        for i in range(n):
            xi = unit_float(cap.static_in[i]).permute(0, 3, 1, 2)
            out = self.body(xi, generator, cap.rate_weight, cap.lam)[0]
            cap.rows[i].copy_(_row(out))

    def _capture(self, x, generator, lr, rate_weight, lam):
        if not isinstance(generator, torch.Generator) \
                or generator.device.type != "cuda":
            raise ValueError("a graph-chained step needs a torch.Generator "
                             "on the card for its noise")
        t0 = time.perf_counter()
        dev = self.device
        cap = SimpleNamespace(
            static_in=torch.empty(x.shape, dtype=x.dtype, device=dev),
            pinned=torch.empty(x.shape, dtype=x.dtype, pin_memory=True),
            copied=torch.cuda.Event(),
            rows=torch.zeros((self.k, 4), device=dev),
            rate_weight=torch.zeros((), device=dev),
            lam=torch.zeros((), device=dev), generator=generator)
        self._upload(cap, x)
        self._scalars(cap, lr, rate_weight, lam)

        saved = self._save_state(generator)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._steps(cap, min(self.WARMUP_STEPS, self.k), generator)
        torch.cuda.current_stream(dev).wait_stream(side)
        self._restore_state(saved, generator)
        torch.cuda.synchronize(dev)
        cap.warmup_s = time.perf_counter() - t0

        # backward makes the gradients in the graph's pool; zero_grad
        # (set_to_none) inside the body frees them for the next step
        self.optimizer.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        before = [getattr(m, a) for m, a in _launch_counters()]
        with torch.cuda.graph(graph), record_phases() as phases:
            self._steps(cap, self.k, generator)
        cap.launches = [getattr(m, a) - b
                        for (m, a), b in zip(_launch_counters(), before)]
        _add_launches([-n for n in cap.launches])
        torch.cuda.synchronize(dev)
        cap.graph, cap.phases = graph, phases
        cap.fingerprint = self._fingerprint()
        capture_s = time.perf_counter() - t0
        cap.stats = COUNTERS.capture(
            capture_s=capture_s, warmup_s=cap.warmup_s,
            record_s=capture_s - cap.warmup_s, launches=dict(zip(
                (f"{m.__name__.rsplit('.', 1)[1]}.{a}"
                 for m, a in _launch_counters()), cap.launches)))
        return cap

    @torch.no_grad()
    def _save_state(self, generator):
        return ([t.clone() for t in self._state_tensors()],
                set(self.optimizer.state), generator.get_state())

    @torch.no_grad()
    def _restore_state(self, saved, generator) -> None:
        values, had_state, rng = saved
        # the tensors saved first; Adam states the warm-up made are fresh:
        # zeros, their step counts 0
        for t, v in zip(self._state_tensors(), values):
            t.copy_(v)
        for p, st in self.optimizer.state.items():
            if p not in had_state:
                for v in st.values():
                    if isinstance(v, torch.Tensor):
                        v.zero_()
        generator.set_state(rng)


def chains_in_graph(device, backend: Optional[str] = None) -> bool:
    """Whether the chained step runs as a CUDA graph: on a card, alone or
    on a NCCL mesh (gloo's collectives cannot be captured, so gloo ranks
    take the plain form)."""
    return torch.device(device).type == "cuda" and backend in (None, "nccl")


def chain_steps(cfg: Config, body: Callable,
                optimizer: torch.optim.Optimizer, model: nn.Module, device,
                take=None, graph: Optional[bool] = None) -> PlainChain:
    """``cfg.steps_per_call`` steps of ``body`` a call: a
    :class:`GraphChain` where ``graph`` (by default: on a card), else a
    :class:`PlainChain`."""
    k = max(cfg.steps_per_call, 1)
    if graph is None:
        graph = chains_in_graph(device)
    if graph:
        return GraphChain(k, cfg.lambda_, body, optimizer, device, take,
                          model)
    return PlainChain(k, cfg.lambda_, body, optimizer, device, take)


def make_chained_train_step(cfg: Config, model: nn.Module,
                            optimizer: torch.optim.Optimizer, device=None
                            ) -> PlainChain:
    """``k = cfg.steps_per_call`` optimizer steps in one call: the JAX
    package's chained step. Moves ``model`` to ``device`` (CUDA unless the
    caller passes another) and returns ``chained_step(batches_u8,
    generator, lr, rate_weight, lam=None) -> Tensor (k, 4)``.

    ``batches_u8`` is the loader's chunk ``(k, B, P, P, 3)`` (uint8, turned
    into floats on the device bit for bit as the loader does; float32 in
    [0, 1] is taken too). The result is step for step what k
    :func:`make_train_step` calls give with the same generator and a
    constant (lr, rate_weight, lam); the host controllers update only at
    chunk boundaries (``train/loop.py`` keeps chunks aligned to them). The
    rows are (loss, mse, rate1, rate2) of each step. On a card the steps
    are one CUDA graph (:class:`GraphChain`; ``optimizer`` from
    ``make_optimizer(..., capturable=True)``), on the CPU k eager steps
    (:class:`PlainChain`)."""
    dev = resolve_device(device)
    full_fp32()
    model.to(dev)
    return chain_steps(cfg, _train_body(cfg, model, optimizer), optimizer,
                       model, dev)


def make_eval_step(cfg: Config, model: nn.Module, device=None
                   ) -> Callable[..., Tuple[RDLossOutput, torch.Tensor]]:
    """Move ``model`` to ``device`` (CUDA unless the caller passes another;
    raises when none is available) and return
    ``eval_step(batch, lam=None) -> (RDLossOutput, xhat)``.

    ``batch`` is NCHW RGB in [0, 1]; it is moved to the device. ``xhat`` is
    the clipped reconstruction in [-0.5, 0.5].

    A call is the span ``eval.step`` (its ``req`` the call's index) around
    ``eval.upload``, the color policy's ``color`` and the model's spans,
    and ``eval.loss``.
    """
    dev = resolve_device(device)
    full_fp32()
    model.to(dev)
    calls = itertools.count()

    @torch.inference_mode()
    def eval_step(batch: torch.Tensor, lam: Optional[float] = None):
        if lam is None:
            lam = cfg.lambda_
        with span("eval.step", next(calls)):
            model.eval()
            with span("eval.upload"):
                batch = batch.to(dev, torch.float32)
            xs, xhat, info_xe, info_xo, _ = apply_color_forward(
                cfg, model, batch)
            with span("eval.loss"):
                xhat = torch.clamp(xhat, -0.5, 0.5)
                return rd_loss3(xs, xhat, info_xe, info_xo, lam, 1.0), xhat

    return eval_step


@dataclasses.dataclass
class PlateauScheduler:
    """Host-side ReduceLROnPlateau (factor 0.5, patience 5, relative
    threshold 1e-4, min_lr 1e-6)."""

    lr: float
    factor: float = 0.5
    patience: int = 5
    threshold: float = 1e-4
    min_lr: float = 1e-6
    best: float = float("inf")
    num_bad: int = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr

    def state_dict(self):
        return {"lr": self.lr, "best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, d):
        self.lr, self.best, self.num_bad = d["lr"], d["best"], d["num_bad"]


@dataclasses.dataclass
class LossSwitchController:
    """Host-side D-only -> R+lambda*D switch: once the windowed training MSE
    drops below ``threshold``, the rate term turns on for good."""

    enabled: bool          # training_loss_switch == 0 means "start D-only"
    threshold: float

    def __post_init__(self):
        self.rate_on = not self.enabled

    def rate_weight(self) -> float:
        return 1.0 if self.rate_on else 0.0

    def observe_window_mse(self, mse: float) -> None:
        if not self.rate_on and mse < self.threshold:
            self.rate_on = True

    def state_dict(self):
        return {"rate_on": self.rate_on}

    def load_state_dict(self, d):
        self.rate_on = d["rate_on"]
