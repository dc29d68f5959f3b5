"""Three-term roofline analysis from dry-run artifacts.

Terms (seconds per step, per hardware set :class:`Hardware`):

    compute    = FLOPs / (chips * peak_flops)
    memory     = HBM bytes / (chips * hbm_bw)
    collective = wire bytes per device / link_bw     (1 link, worst case)

Two sets: :data:`V5E`, the reference's TPU v5e constants (197e12 bf16
FLOP/s, 819e9 B/s, one 50e9 B/s ICI link), kept so the port's rows can
be held against the reference's; and :data:`H100`, the default of the
port's reports: 989e12 dense bf16 tensor FLOP/s and 3.35e12 B/s of HBM3
(H100 SXM data sheet).  Its link is the reference's worst case, one
link a device: a 256- or 512-GPU mesh spans 32 or 64 eight-GPU nodes,
so a collective over the ``data`` axis crosses nodes, through one
InfiniBand NDR port a GPU (400 Gb/s, 50e9 B/s).  Inside a node NVLink 4
gives 450e9 B/s a direction (:data:`NVLINK_BW`); the roofline does not
use it, as the reference does not split its links.

FLOPs and HBM bytes are **analytic** (formulas below), as the
reference's are: its XLA ``cost_analysis`` counts loop bodies once.  The
port's dry run runs eagerly, so its collective log is already the
per-step volume; the reference's loop-corrected HLO totals
(:mod:`repro_torch.core.hlo`) read the same.  The dry run's counted
FLOPs are carried alongside for reference.

The dominant term is the bottleneck; the roofline fraction we report is
compute / max(compute, memory, collective) — the fraction of peak the
step could reach if perfectly overlapped.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..configs import get_config, shape_by_name
from ..configs.base import ModelConfig, ShapeConfig

# ----------------------------------------------------- hardware constants
PEAK_FLOPS = 197e12          # bf16 FLOP/s per chip
HBM_BW = 819e9               # bytes/s per chip
LINK_BW = 50e9               # bytes/s per ICI link (1 link assumed)


@dataclass(frozen=True)
class Hardware:
    """Per-chip peaks of one hardware set: bf16 FLOP/s, HBM bytes/s and
    the one link's bytes/s a collective's wire bytes cross."""

    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float


#: the reference's TPU v5e constants, for parity with its rows
V5E = Hardware("tpu-v5e", PEAK_FLOPS, HBM_BW, LINK_BW)
#: NVLink 4 inside an eight-GPU node, bytes/s a direction (not used by
#: the roofline's one-link worst case)
NVLINK_BW = 450e9
#: H100 SXM: dense bf16 tensor FLOP/s, HBM3 bytes/s, and one InfiniBand
#: NDR port a GPU between nodes (400 Gb/s)
H100 = Hardware("h100-sxm", 989e12, 3.35e12, 50e9)
HARDWARE = {"h100": H100, "v5e": V5E}


def model_flops_share(n_params: float, tokens: float, wall_s: float,
                      hw: Hardware = H100) -> float:
    """A training step's model-FLOPs share of one chip's peak: ``6 N T``
    (forward and backward over ``N`` parameters and ``T`` tokens) over
    ``wall_s`` seconds of ``hw.peak_flops``."""
    return 6 * n_params * tokens / (wall_s * hw.peak_flops)

#: wire-byte multiplier per collective kind (ring algorithms, large N)
WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0,
               "reduce-scatter": 1.0, "all-to-all": 1.0,
               "collective-permute": 1.0}


# ------------------------------------------------------------- FLOP model
def _attn_layers(cfg: ModelConfig) -> Tuple[int, int]:
    """(n attention layers, attention width H*dh)."""
    if cfg.family in ("dense", "moe", "encoder", "vlm"):
        return cfg.n_layers, cfg.n_heads * cfg.dh
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every, cfg.n_heads * cfg.dh
    if cfg.family == "ssm":  # mLSTM quadratic form acts like attention
        k = cfg.xlstm.slstm_every
        d_in = int(cfg.xlstm.mlstm_proj_factor * cfg.d_model)
        return cfg.n_layers - cfg.n_layers // k, d_in
    return 0, 0


def analytic_flops(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, float]:
    """Per-step FLOPs: model (6/2 * N_active * tokens) + attention terms."""
    B, S = shape.global_batch, shape.seq_len
    T = B * S
    N_act = cfg.active_param_count()
    n_attn, d_attn = _attn_layers(cfg)
    causal = 0.5 if (cfg.causal and cfg.family != "encoder") else 1.0
    win = cfg.attn_window or S

    if shape.kind == "train":
        model = 6.0 * N_act * T
        attn = n_attn * 12.0 * B * S * min(S, win) * d_attn * causal
        total = model + attn
        # remat recompute: one extra forward of the block stack
        recompute = (2.0 * N_act * T + n_attn * 4.0 * B * S *
                     min(S, win) * d_attn * causal) if cfg.remat else 0.0
        return {"model_flops": model, "attn_flops": attn,
                "recompute_flops": recompute,
                "total_flops": total + recompute}
    if shape.kind == "prefill":
        model = 2.0 * N_act * T
        attn = n_attn * 4.0 * B * S * min(S, win) * d_attn * causal
        return {"model_flops": model, "attn_flops": attn,
                "recompute_flops": 0.0, "total_flops": model + attn}
    # decode: one token per lane against an S-long context
    model = 2.0 * N_act * B
    attn = n_attn * 4.0 * B * min(S, win) * d_attn
    return {"model_flops": model, "attn_flops": attn,
            "recompute_flops": 0.0, "total_flops": model + attn}


# ------------------------------------------------------------- byte model
def analytic_bytes(cfg: ModelConfig, shape: ShapeConfig,
                   opt_state_bytes_per_param: float = 8.0,
                   n_micro: int = 1) -> Dict[str, float]:
    """Per-step global HBM bytes."""
    B, S = shape.global_batch, shape.seq_len
    T = B * S
    P = cfg.param_count()
    pb = 2.0  # bf16 params
    d = cfg.d_model

    if shape.kind == "train":
        # fwd read + bwd read (+ remat re-read), grad write+read, optimizer
        weight_traffic = P * pb * (3.0 if cfg.remat else 2.0) * n_micro \
            + P * (pb * 2.0)                       # grads w+r
        opt_traffic = P * (2.0 * opt_state_bytes_per_param + 2.0 * pb)
        act_traffic = 10.0 * T * d * pb * cfg.n_layers / max(n_micro, 1) \
            * n_micro
        return {"weight_bytes": weight_traffic, "opt_bytes": opt_traffic,
                "act_bytes": act_traffic,
                "total_bytes": weight_traffic + opt_traffic + act_traffic}
    if shape.kind == "prefill":
        weight_traffic = P * pb
        act_traffic = 8.0 * T * d * pb * cfg.n_layers
        return {"weight_bytes": weight_traffic, "opt_bytes": 0.0,
                "act_bytes": act_traffic,
                "total_bytes": weight_traffic + act_traffic}
    # decode: weights once per step + KV cache read
    n_attn, _ = _attn_layers(cfg)
    win = cfg.attn_window or S
    kv_bytes = n_attn * B * min(S, win) * cfg.n_kv_heads * cfg.dh * 2 * pb
    if cfg.family == "ssm":
        d_in = int(cfg.xlstm.mlstm_proj_factor * cfg.d_model)
        dh_in = d_in // cfg.n_heads
        kv_bytes = cfg.n_layers * B * cfg.n_heads * dh_in * dh_in * 4.0
    if cfg.family == "hybrid":
        d_inner = cfg.ssm.expand * cfg.d_model
        H = d_inner // cfg.ssm.head_dim
        kv_bytes += cfg.n_layers * B * H * cfg.ssm.head_dim * \
            cfg.ssm.state_dim * 4.0 * 2
    weight_traffic = cfg.active_param_count() * pb
    return {"weight_bytes": weight_traffic, "opt_bytes": 0.0,
            "act_bytes": kv_bytes,
            "total_bytes": weight_traffic + kv_bytes}


# ---------------------------------------------------------------- reports
@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    roofline_fraction: float      # compute / limiting term
    model_flops: float
    total_flops: float
    useful_ratio: float           # model / total (remat+attn overhead)
    hlo_flops_raw: float
    coll_bytes_per_dev: float
    peak_gib_per_dev: float
    note: str = ""


def roofline_row(record: Dict, coll_totals: Optional[Dict[str, int]] = None,
                 hw: Hardware = H100) -> RooflineRow:
    """record = one dryrun JSON artifact; coll_totals = per-device
    collective bytes by kind (the artifact's own when ``None``); ``hw``
    the hardware set whose peaks divide the terms."""
    cfg = get_config(record["arch"], record["shape"])
    shape = shape_by_name(record["shape"])
    chips = record["n_devices"]
    n_micro = record.get("n_microbatches", 1)

    fl = analytic_flops(cfg, shape)
    opt_b = 2.06 if record["arch"] == "arctic-480b" else 8.0
    by = analytic_bytes(cfg, shape, opt_state_bytes_per_param=opt_b,
                        n_micro=n_micro)

    compute_s = fl["total_flops"] / (chips * hw.peak_flops)
    memory_s = by["total_bytes"] / (chips * hw.hbm_bw)

    if coll_totals is not None:
        colls = coll_totals
    elif record.get("collectives_per_device_loop_corrected"):
        # loop-corrected totals (entry-reachable, while trip counts
        # multiplied through) — the faithful per-step volume
        colls = record["collectives_per_device_loop_corrected"]
    else:
        colls = {k: v["bytes"] for k, v in
                 record.get("collectives_per_device", {}).items()}
    wire = sum(WIRE_FACTOR.get(k, 1.0) * b for k, b in colls.items())
    collective_s = wire / hw.link_bw

    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    limiting = max(terms.values())
    return RooflineRow(
        arch=record["arch"], shape=record["shape"], mesh=record["mesh"],
        chips=chips,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant,
        roofline_fraction=compute_s / limiting if limiting > 0 else 1.0,
        model_flops=fl["model_flops"], total_flops=fl["total_flops"],
        useful_ratio=fl["model_flops"] / fl["total_flops"],
        hlo_flops_raw=record.get("cost", {}).get("flops", 0.0) or 0.0,
        coll_bytes_per_dev=wire,
        peak_gib_per_dev=record.get("peak_bytes_per_device", 0) / 2**30,
    )


def load_records(dryrun_dir: str) -> List[Dict]:
    out = []
    for p in sorted(Path(dryrun_dir).glob("*.json")):
        out.append(json.loads(p.read_text()))
    return out


def build_table(dryrun_dir: str, mesh: str = "pod16x16",
                hw: Hardware = H100) -> List[RooflineRow]:
    rows = []
    for rec in load_records(dryrun_dir):
        if rec["mesh"] != mesh:
            continue
        rows.append(roofline_row(rec, hw=hw))
    return rows


def format_table(rows: List[RooflineRow]) -> str:
    hdr = (f"{'arch':<22s} {'shape':<12s} {'compute':>10s} {'memory':>10s} "
           f"{'collective':>10s} {'dominant':>10s} {'frac':>6s} "
           f"{'useful':>7s} {'GiB/dev':>8s}")
    lines = [hdr, "-" * len(hdr)]
    for r in sorted(rows, key=lambda r: (r.arch, r.shape)):
        lines.append(
            f"{r.arch:<22s} {r.shape:<12s} {r.compute_s:10.4f} "
            f"{r.memory_s:10.4f} {r.collective_s:10.4f} {r.dominant:>10s} "
            f"{r.roofline_fraction:6.2f} {r.useful_ratio:7.2f} "
            f"{r.peak_gib_per_dev:8.2f}")
    return "\n".join(lines)


def main(argv=None) -> int:
    """``python -m repro_torch.core.roofline DIR [--mesh M] [--hw h100|v5e]``:
    the table of the dry-run artifacts in ``DIR`` (H100 by default)."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("dryrun_dir")
    ap.add_argument("--mesh", default="pod16x16")
    ap.add_argument("--hw", choices=sorted(HARDWARE), default="h100")
    args = ap.parse_args(argv)
    hw = HARDWARE[args.hw]
    print(f"roofline on {hw.name}: {hw.peak_flops:.4g} FLOP/s, "
          f"{hw.hbm_bw:.4g} B/s HBM, {hw.link_bw:.4g} B/s link")
    print(format_table(build_table(args.dryrun_dir, args.mesh, hw)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
