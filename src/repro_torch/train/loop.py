"""Fault-tolerant training loop, the JAX package's (``repro.train.loop``) on
eager PyTorch:

  * checkpoint every ``ckpt_every`` steps (atomic; retention) + final;
  * resume from the latest checkpoint: a bit-identical continuation where
    the device's arithmetic is deterministic (data keyed by (seed, step), so
    a replacement host replays the same stream; on the card
    ``torch.use_deterministic_algorithms(True)`` with
    ``CUBLAS_WORKSPACE_CONFIG`` set before CUDA starts);
  * preemption: SIGTERM/SIGINT (or the ``preempt_at`` hook) saves a
    checkpoint at once, then stops cleanly;
  * straggler telemetry: per-step wall time EWMA + outlier flag, recorded
    in ``history``.
"""
from __future__ import annotations

import os
import signal
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from ..ckpt.manager import CheckpointManager
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from ..tree import map_with_path, tree_leaves_with_path, tree_map


@dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_keep: int = 3
    log_every: int = 10
    straggler_ewma: float = 0.9
    straggler_factor: float = 3.0


@dataclass
class TrainResult:
    step: int
    history: list[dict] = field(default_factory=list)
    preempted: bool = False
    resumed_from: int | None = None


def value_and_grad(loss_fn: Callable, params, batch):
    """``((loss, metrics), grads)`` of ``loss_fn(params, batch)``, the
    gradients a tree like ``params`` (the reference's
    ``jax.value_and_grad(..., has_aux=True)``, by autograd)."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    paths, leaves = zip(*tree_leaves_with_path(live))
    loss, metrics = loss_fn(live, batch)
    grads = dict(zip(paths, torch.autograd.grad(loss, leaves, allow_unused=True,
                                                materialize_grads=True)))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), map_with_path(lambda path, _: grads[path], params)


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig):
    """loss_fn(params, batch) -> (loss, metrics). Returns the step function
    (params, opt_state, batch) -> (params, opt_state, metrics)."""

    def step(params, opt_state, batch):
        (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
        params, opt_state, opt_m = adamw_update(grads, opt_state, params, opt_cfg)
        return params, opt_state, {"loss": loss, **metrics, **opt_m}

    return step


def train(
    params,
    loss_fn: Callable,
    data_fn: Callable[[int], Any],  # step -> batch (deterministic by step)
    loop_cfg: TrainLoopConfig,
    opt_cfg: AdamWConfig = AdamWConfig(),
    resume: bool = True,
    preempt_at: int | None = None,  # test hook: simulate preemption
) -> tuple[Any, TrainResult]:
    mgr = CheckpointManager(loop_cfg.ckpt_dir, keep=loop_cfg.ckpt_keep)
    # the step returns new tensors and never writes the caller's
    opt_state = adamw_init(params, opt_cfg)
    start = 0
    resumed_from = None
    if resume and mgr.latest_step() is not None:
        (params, opt_state), meta = mgr.restore((params, opt_state))
        start = int(meta["step"])
        resumed_from = start

    step_fn = make_train_step(loss_fn, opt_cfg)
    result = TrainResult(step=start, resumed_from=resumed_from)

    stop = {"flag": False}

    def _handler(signum, frame):
        stop["flag"] = True

    old_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old_handlers[sig] = signal.signal(sig, _handler)
        except ValueError:
            pass  # non-main thread (tests)

    ewma = None
    try:
        for step in range(start, loop_cfg.total_steps):
            if preempt_at is not None and step == preempt_at:
                stop["flag"] = True
            if stop["flag"]:
                mgr.save(step, (params, opt_state))
                result.preempted = True
                result.step = step
                return params, result
            t0 = time.perf_counter()
            batch = data_fn(step)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])  # waits for the device
            dt = time.perf_counter() - t0
            ewma = dt if ewma is None else (
                loop_cfg.straggler_ewma * ewma + (1 - loop_cfg.straggler_ewma) * dt
            )
            rec = {
                "step": step,
                "loss": loss,
                "grad_norm": float(metrics.get("grad_norm", 0.0)),
                "step_time": dt,
                "straggler": bool(dt > loop_cfg.straggler_factor * ewma and step > start + 3),
            }
            result.history.append(rec)
            if (step + 1) % loop_cfg.ckpt_every == 0:
                mgr.save(step + 1, (params, opt_state))
            result.step = step + 1
        mgr.save(loop_cfg.total_steps, (params, opt_state))
    finally:
        for sig, h in old_handlers.items():
            signal.signal(sig, h)
    return params, result
