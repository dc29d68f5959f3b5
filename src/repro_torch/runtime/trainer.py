"""Power-aware training runtime (the paper's technique as a first-class
feature) with fault tolerance and elastic restart: the port of the
reference's ``runtime/trainer.py``.

The training loop is real (real steps, real loss, on the card unless the
caller asks for the CPU).  Around it sits the *cluster model*: N virtual
hosts with per-host speed factors (heterogeneity) and per-step data skew,
each under a power cap drawn from the cluster bound ``P``.  After every
step the trainer:

  1. models per-host step times  t_h = base * skew_h / speed_h / rate(cap_h)
     where ``rate`` comes from the paper's modelled TPU v5e DVFS LUT
     (``repro_torch.core.power.tpu_v5e_lut``: the virtual hosts keep the
     reference's LUT, whatever device runs the steps);
  2. detects the barrier blackout structure (everyone waits for the
     straggler — the paper's Fig. 2) and emits §V-A report messages
     through the per-host ReportManagers;
  3. lets the Algorithm-1 controller redistribute the blocked hosts'
     power to the straggler(s); the new caps take effect next step.

Fault tolerance: atomic checkpoints every ``ckpt_every`` steps; injected
host failures trigger restore-from-latest + elastic re-shard (the data
pipeline re-splits the global batch over the surviving hosts).

The model is an ``nn.Module`` (its weights created without gradients, as
for serving; the trainer turns them on with ``requires_grad_(True)``) and
the step updates it and the optimizer state in place.  ``model=`` starts
from a copy of the caller's weights instead of the seed's (the tests
carry the reference's across); the caller's module is never modified.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.backends.engine import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager, flatten_tree
from repro_torch.configs.base import ModelConfig
from repro_torch.core.block_detector import (ReportManager, blocked_report,
                                             running_report)
from repro_torch.core.heuristic import PowerDistributionController
from repro_torch.core.power import NodeSpec, operating_point, tpu_v5e_lut
from repro_torch.data.pipeline import DataConfig, global_batch
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params
from repro_torch.optim import AdamWConfig, init_opt_state

#: checkpoints go under the checkout's (git-ignored) build directory
#: unless the config names another
DEFAULT_CKPT_DIR = str(Path(__file__).resolve().parents[3] / "build"
                       / "train_ckpt")


@dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = DEFAULT_CKPT_DIR
    keep_last: int = 2
    seed: int = 0
    # cluster model
    n_hosts: int = 8
    power_bound_w: float = 0.0      # 0 -> 85% of n_hosts * TDP
    power_aware: bool = True        # run the Algorithm-1 controller
    controller_rtt_s: float = 0.002
    host_speed_spread: float = 0.15  # heterogeneity (+-)
    data_skew_spread: float = 0.25   # per-step straggler skew (+-)
    # fault tolerance
    fail_at_steps: Tuple[int, ...] = ()
    n_microbatches: int = 1


@dataclass
class StepRecord:
    step: int
    loss: float
    wall_s: float
    makespan_power_aware: float
    makespan_equal_share: float
    straggler: int
    caps_w: List[float]


class FailureInjected(RuntimeError):
    pass


class PowerAwareTrainer:
    def __init__(self, model_cfg: ModelConfig, data_cfg: DataConfig,
                 opt_cfg: AdamWConfig, tcfg: TrainerConfig, device=None,
                 model: Optional[torch.nn.Module] = None):
        self.mcfg = model_cfg
        self.dcfg = data_cfg
        self.ocfg = opt_cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self._model_source = model
        self.rng = np.random.default_rng(tcfg.seed)

        self.ckpt = CheckpointManager(tcfg.ckpt_dir,
                                      keep_last=tcfg.keep_last)
        self.train_step = make_train_step(
            model_cfg, opt_cfg, n_microbatches=tcfg.n_microbatches)

        # ---- cluster model (virtual hosts with a TPU DVFS LUT each)
        self.n_hosts = tcfg.n_hosts
        lut = tpu_v5e_lut()
        self.specs = [NodeSpec(lut,
                               speed=1.0 + self.rng.uniform(
                                   -tcfg.host_speed_spread,
                                   tcfg.host_speed_spread))
                      for _ in range(self.n_hosts)]
        self.P = tcfg.power_bound_w or 0.85 * self.n_hosts * lut.p_max
        self.p_o = self.P / self.n_hosts
        self.caps = np.full(self.n_hosts, self.p_o)
        self.controller = PowerDistributionController(
            self.P, self.n_hosts, specs=self.specs) \
            if tcfg.power_aware else None
        self.rms = [ReportManager(node=h, breakeven_s=2 * tcfg.controller_rtt_s)
                    for h in range(self.n_hosts)]

        self.history: List[StepRecord] = []
        self._failed_once: set = set()
        self._init_state()

    # ------------------------------------------------------------ state
    def _init_state(self) -> None:
        """Fresh weights (the seed's, or a copy of ``model=``'s) and zero
        moments, then the latest checkpoint's state if there is one
        (restored through the host into the tensors in place, so the
        device never holds two copies)."""
        self.model = None       # free the old state before the new one
        self.opt_state = None
        if self._model_source is not None:
            self.model = copy.deepcopy(self._model_source).to(self.device)
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.tcfg.seed)
            self.model = init_params(self.mcfg, gen)
        self.model.requires_grad_(True)
        self.opt_state = init_opt_state(dict(self.model.named_parameters()),
                                        self.ocfg)
        self.start_step = 0
        latest = self.ckpt.latest_step()
        if latest is not None:
            live = self.state()
            state, step, _extra = self.ckpt.restore(live, device="cpu")
            with torch.no_grad():
                for (_, dst), (_, src) in zip(flatten_tree(live),
                                              flatten_tree(state)):
                    dst.copy_(src)
            self.start_step = step + 1

    def state(self) -> Dict:
        """What a checkpoint holds: ``{"params": model.state_dict(),
        "opt": opt_state}`` (the live tensors)."""
        return {"params": self.model.state_dict(), "opt": self.opt_state}

    # --------------------------------------------------- cluster modelling
    def _host_times(self, base_s: float, step: int, caps: np.ndarray
                    ) -> np.ndarray:
        """Modelled per-host step time under the given caps."""
        rng = np.random.default_rng(self.tcfg.seed * 7919 + step)
        skew = 1.0 + rng.uniform(-self.tcfg.data_skew_spread,
                                 self.tcfg.data_skew_spread, self.n_hosts)
        times = np.empty(self.n_hosts)
        for h, spec in enumerate(self.specs):
            op = operating_point(spec.lut, caps[h])
            # rate relative to flat-out: duty * f/f_max (compute-bound step)
            rate = op.duty * op.freq_mhz / spec.lut.f_max
            times[h] = base_s * skew[h] / (spec.speed * rate)
        return times

    def _power_round(self, times: np.ndarray, step: int) -> None:
        """Feed the barrier blackout structure into Algorithm 1."""
        if self.controller is None:
            return
        straggler = int(times.argmax())
        now = float(step)
        msgs = []
        for h in range(self.n_hosts):
            if h == straggler:
                msgs.extend(self.rms[h].offer(running_report(h, now), now))
                continue
            p_g = operating_point(self.specs[h].lut,
                                  self.caps[h]).power_w \
                - self.specs[h].lut.idle_w
            rep = blocked_report(h, {straggler}, p_g, now)
            msgs.extend(self.rms[h].offer(rep, now))
        for h in range(self.n_hosts):
            msgs.extend(self.rms[h].poll(now + 10 * self.rms[h].breakeven_s))
        for m in msgs:
            for gamma in self.controller.process_message(m):
                self.caps[gamma.node] = gamma.power_bound_w

    # ------------------------------------------------------------- run loop
    def run(self, steps: Optional[int] = None) -> List[StepRecord]:
        total = steps if steps is not None else self.tcfg.steps
        step = self.start_step
        while step < total:
            try:
                if step in self.tcfg.fail_at_steps and \
                        step not in self._failed_once:
                    self._failed_once.add(step)
                    raise FailureInjected(f"injected host failure at "
                                          f"step {step}")
                batch = global_batch(self.dcfg, step, n_hosts=1)
                t0 = time.perf_counter()
                self.opt_state, metrics = self.train_step(
                    self.model, self.opt_state, batch, step)
                loss = float(metrics["loss"])
                wall = time.perf_counter() - t0

                times_aware = self._host_times(wall, step, self.caps)
                times_equal = self._host_times(
                    wall, step, np.full(self.n_hosts, self.p_o))
                self._power_round(times_aware, step)
                self.history.append(StepRecord(
                    step=step, loss=loss, wall_s=wall,
                    makespan_power_aware=float(times_aware.max()),
                    makespan_equal_share=float(times_equal.max()),
                    straggler=int(times_aware.argmax()),
                    caps_w=[float(c) for c in self.caps]))

                if (step + 1) % self.tcfg.ckpt_every == 0 or \
                        step + 1 == total:
                    self.ckpt.save(step, self.state(), extra={"loss": loss})
                step += 1
            except FailureInjected:
                # fault tolerance: restore latest checkpoint, drop a host
                # (elastic re-shard of the power budget + data pipeline)
                self._recover_from_failure()
                step = self.start_step

        return self.history

    def _recover_from_failure(self) -> None:
        if self.n_hosts > 2:
            self.n_hosts -= 1
            self.specs = self.specs[: self.n_hosts]
            self.rms = self.rms[: self.n_hosts]
            self.caps = np.full(self.n_hosts, self.P / self.n_hosts)
            if self.controller is not None:
                self.controller = PowerDistributionController(
                    self.P, self.n_hosts, specs=self.specs)
        self._init_state()  # restores from latest checkpoint

    # ----------------------------------------------------------- reporting
    def speedup_summary(self) -> Dict[str, float]:
        if not self.history:
            return {}
        aware = sum(r.makespan_power_aware for r in self.history)
        equal = sum(r.makespan_equal_share for r in self.history)
        return {
            "total_makespan_power_aware_s": aware,
            "total_makespan_equal_share_s": equal,
            "speedup": equal / aware if aware > 0 else 1.0,
            "final_loss": self.history[-1].loss,
            "first_loss": self.history[0].loss,
        }
