"""Training: one step after another through the port's
``launch.steps.make_train_step`` (loss, autograd with remat, AdamW in
place), each on fresh rows from the seed.

Set-up builds the model and the optimizer state once and warms every shape
with ``warmup_steps`` steps of the window's own call; it then puts the
weights and the optimizer state back to where the seed starts them (in
place, the same objects) and hands them to the window.  The window's first
``check_steps`` steps are the ones the check compares: their losses, the
first step's gradient as AdamW took it, and each leaf's change over them,
read before the next step."""

from __future__ import annotations

import math
import time

import torch

from .. import faults, port, seeded
from ..judge import train_numbers
from ..loop import Item
from ..reference import lm as ref
from ..seeded import dims


class Program:
    def __init__(self, run):
        conf, t = run.conf, run.traffic
        cfg = port.model_config(conf, run.config_name)   # puts src on the path
        from repro_torch.launch.steps import make_train_step
        from repro_torch.optim import AdamWConfig, adamw_init
        self.run, self.dev = run, run.device
        self.B, self.S, self.V = t["batch"], t["seq_len"], dims(conf)["vocab"]
        self.checks, self.b1 = t["check_steps"], t["optimizer"]["b1"]
        self.params = port.lm(cfg, self._start(), conf)
        run.mark("port and weights")
        self.opt_state = adamw_init(dict(self.params.named_parameters()))
        step = make_train_step(cfg, AdamWConfig(**t["optimizer"]),
                               remat=t["remat"])
        self.step = faults.train_step(step, run.fault)
        self.n = 0
        for _ in range(t["warmup_steps"]):
            float(self._step()["loss"])
        self._grad_norms(), self._change_norms()   # their kernels load here
        self._restart()
        run.mark("warm-up steps")
        self.record = {"loss": []}

    def _start(self):
        return seeded.weights(self.run.conf, self.run.seed, self.dev,
                              seeded.DTYPES[self.run.conf["param_dtype"]])

    @torch.no_grad()
    def _restart(self):
        """The weights and AdamW's state as the seed starts them."""
        start = self._start()
        for n, p in self.params.named_parameters():
            p.copy_(start[n])
        del start
        for k in ("m", "v"):
            for t in self.opt_state[k].values():
                t.zero_()
        self.opt_state["step"] = 0
        self.n = 0

    def _step(self):
        batch = seeded.train_batch(self.run.seed, self.n, self.B, self.S,
                                   self.V, self.dev)
        self.params, self.opt_state, metrics = self.step(
            self.params, self.opt_state, batch)
        self.n += 1
        return metrics

    def one(self, i: int) -> Item:
        issued = time.perf_counter()
        with torch.profiler.record_function("portbench.train_step"):
            metrics = self._step()
        queued = time.perf_counter()
        loss = float(metrics["loss"])          # the step's result on the host
        done = time.perf_counter()
        if not math.isfinite(loss):
            self.run.failed += 1
        if self.n <= self.checks:
            self._keep(loss, metrics)
        return Item(issued, done, self.B * self.S, queued - issued)

    def _keep(self, loss: float, metrics) -> None:
        """What the check compares, read from the checked steps as they
        end."""
        self.record["loss"].append(loss)
        if self.n == 1:
            self.record["gnorm"] = float(metrics["grad_norm"])
            self.record["grad_norms"] = self._grad_norms()
        if self.n == self.checks:
            self.record["change_norms"] = self._change_norms()

    @torch.no_grad()
    def _grad_norms(self) -> dict:
        """Each leaf's norm of the first gradient as AdamW applied it,
        from m after one step: m = (1 - b1) g."""
        m = self.opt_state["m"]
        norms = torch.stack([t.norm() for t in m.values()]).tolist()
        return {n: x / (1 - self.b1) for n, x in zip(m, norms)}

    @torch.no_grad()
    def _change_norms(self) -> dict:
        """Each leaf's norm of its change from the seed's start."""
        start = self._start()
        named = list(self.params.named_parameters())
        norms = torch.stack([(p - start[n]).norm()
                             for n, p in named]).tolist()
        return {n: x for (n, _), x in zip(named, norms)}

    def counters(self) -> dict:
        return {}

    def outputs(self, sample) -> dict:
        """The checked steps' record; where the window ended before all of
        them, the rest run now through the same call."""
        while self.n < self.checks:
            self.one(self.n)
        out = dict(self.record)
        del self.params, self.opt_state, self.step
        return out


def sample(run, n_done: int):
    return list(range(run.traffic["check_steps"]))


def _batches(run):
    t = run.traffic
    return [seeded.train_batch(run.seed, k, t["batch"], t["seq_len"],
                               dims(run.conf)["vocab"], run.device)
            for k in range(t["check_steps"])]


def _reference(run, precision: str) -> dict:
    ref.float32_only()
    flat = seeded.weights(run.conf, run.seed, run.device,
                          seeded.DTYPES[run.conf["param_dtype"]])
    return ref.train(flat, run.conf, _batches(run), run.traffic["optimizer"],
                     ref.Precision(precision))


def control(run, sample_) -> dict:
    """The reference in float8 products, in the program's place."""
    return _reference(run, "fp8")


def judge(run, outputs) -> dict:
    return train_numbers(outputs, _reference(run, "float32"))


def flops_per_item(run) -> float:
    from ..counts import train_step_flops
    t = run.traffic
    return train_step_flops(run.conf, t["batch"], t["seq_len"])
