"""Differentiable power-redistribution simulator: the port of the
reference's ``repro.diff`` on torch autograd.

A smoothed relaxation of the batched wave simulator
(:mod:`repro_torch.core.batchsim`) built from two substitutions:

* the hard ``min`` over the wave's candidate event times becomes a
  temperature-annealed Boltzmann soft minimum
  (:mod:`repro_torch.diff.relax`);
* the stepped power->frequency LUT translation becomes the
  piecewise-linear interpolation that ``smooth=True`` selects in
  :func:`repro_torch.core.power.batched_operating_point`.

``soft_makespan`` is then differentiable with ``torch.autograd`` (and
maps over a batch with ``torch.func.vmap``) and converges to the exact
``BatchSimulator(smooth_lut=True)`` makespan as the temperature goes to
zero.  On top of it sit :mod:`repro_torch.diff.optimize`
(gradient-descended static cap schedules against the ILP) and
:mod:`repro_torch.diff.train` (the ``"learned"`` MLP policy's trainer,
``python -m repro_torch.diff.train``).  Entry points run on the card
unless given ``device="cpu"``.
"""

from __future__ import annotations

_LAZY = {
    "smooth_operating_point": "relax",
    "soft_min_time": "relax",
    "soft_max_time": "relax",
    "SoftArrays": "softsim",
    "build_soft_arrays": "softsim",
    "soft_makespan": "softsim",
    "soft_makespan_policy": "softsim",
    "optimize_static_caps": "optimize",
    "evaluate_static_caps": "optimize",
    "train_policy": "train",
}


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib

    mod = importlib.import_module(f"{__name__}.{module}")
    return getattr(mod, name)


__all__ = list(_LAZY)
