"""Analytic roofline attribution for the port's stages and kernels.

The counterpart of the JAX package's ``utils/roofline.py``.  For a timed
stage, combine

  - an analytic count of the operations it executes per transition (the
    products the port's kernels run), and
  - an analytic count of its device-memory bytes (inputs read and outputs
    written once; state kept in shared memory or registers counts zero),

with the measured seconds into achieved rates, percent of the card's peak
for each, and the resource that binds.

The peaks are one NVIDIA H100 SXM's, from its data sheet at the full power
limit of 700 W (dense rates, no sparsity).  The port runs its float32
products in full float32 (``allow_tf32`` off, and the kernels on the CUDA
cores), so the float32 rate is the denominator of ``stage``; the bf16
tensor-core rate is the peak a bf16 stage would be held against (none yet:
the CNN's bf16 bank computes on bf16-rounded operands in float32).
"""

from __future__ import annotations

from typing import Optional

# NVIDIA H100 SXM data sheet, 700 W
PEAK_FLOPS_FP32 = 67e12  # CUDA cores, float32
PEAK_FLOPS_BF16 = 989e12  # tensor cores, bf16 dense
PEAK_HBM_BPS = 3.35e12  # HBM3


def mlp_forward_flops(
    n_cells: int, hidden: int, n_layers: int, n_actions: int,
    towers: int = 2,
) -> float:
    """Executed FLOPs of ONE row through the MLP forward, 2 per MAC.

    The port's kernels run the towers as they are: ``towers=2`` is the pi
    tower with its (H, A) action head and the vf tower with its (H, 1) value
    head, each ``n_layers`` dense layers of width H; ``towers=1`` is the pi
    tower and action head alone (as ``policy_tower_flops``).  The TPU's
    block-diagonal ``[W_pi|W_vf]`` packing, whose zero blocks the JAX count
    includes, is not used here."""
    per_tower = 2.0 * n_cells * hidden + 2.0 * (n_layers - 1) * hidden * hidden
    fl = towers * per_tower + 2.0 * hidden * n_actions
    if towers == 2:
        fl += 2.0 * hidden  # value head
    return fl


def cnn_forward_flops(
    n_cells: int, filters: int = 64, features_dim: int = 128,
    tower_width: int = 128, tower_layers: int = 2, n_actions: int = 0,
    towers: int = 2,
) -> float:
    """One row through the CnnPolicy forward: 5 SAME 3x3 convs (1->f, then
    4x f->f), flatten->features dense, two [128,128] towers + heads.  2
    FLOPs per MAC; BN/ReLU not counted."""
    A = n_actions or n_cells
    fl = 2.0 * 9 * 1 * filters * n_cells  # conv_in
    fl += 4 * 2.0 * 9 * filters * filters * n_cells  # four f->f convs
    fl += 2.0 * (n_cells * filters) * features_dim  # features dense
    per_tower = 2.0 * features_dim * tower_width
    per_tower += 2.0 * (tower_layers - 1) * tower_width * tower_width
    fl += towers * per_tower
    fl += 2.0 * tower_width * A + 2.0 * tower_width * 1  # heads
    return fl


def cnn_gathered_bank_flops(
    n_cells: int, pool: int, filters: int = 64, features_dim: int = 128,
    tower_width: int = 128, tower_layers: int = 2, n_actions: int = 0,
) -> float:
    """Per-transition opponent-pass FLOPs of the gathered CNN bank: ONE
    member's conv stack per env plus (pool + 1) weight-dense pi towers on
    the env's features.  Compare ``pool x cnn_forward_flops`` for the dense
    pass."""
    A = n_actions or n_cells
    conv = 2.0 * 9 * 1 * filters * n_cells + 4 * 2.0 * 9 * filters * filters * n_cells
    tower = 2.0 * (n_cells * filters) * features_dim
    tower += 2.0 * features_dim * tower_width
    tower += 2.0 * (tower_layers - 1) * tower_width * tower_width
    tower += 2.0 * tower_width * A
    return conv + (pool + 1) * tower


def policy_tower_flops(n_cells: int, hidden: int, n_layers: int, n_actions: int) -> float:
    """One row through the pi tower + action head only (opponent passes)."""
    fl = 2.0 * n_cells * hidden
    fl += 2.0 * (n_layers - 1) * hidden * hidden
    fl += 2.0 * hidden * n_actions
    return fl


def stage(
    name: str,
    seconds: float,
    transitions: int,
    flops: float,
    hbm_bytes: Optional[float],
    note: Optional[str] = None,
) -> dict:
    """One roofline row: achieved rates, percent of peak, binding resource.

    ``flops``/``hbm_bytes`` are totals for the measured call (0 where a stage
    has none: env stepping runs no products).  ``hbm_bytes=None`` means no
    byte model exists for what ran; the row then omits the memory fields and
    classifies ``bound`` from the operations alone.  The port computes in
    float32, so the float32 rate is the peak."""
    fps = flops / seconds
    pct_flops = 100.0 * fps / PEAK_FLOPS_FP32
    row = {
        "stage": name,
        "ms": round(seconds * 1e3, 3),
        "flops_per_transition": round(flops / max(transitions, 1)),
        "achieved_tflops": round(fps / 1e12, 3),
        "pct_peak_flops": round(pct_flops, 2),
    }
    if hbm_bytes is None:
        row["hbm_model"] = "none for this backend"
        row["bound"] = "compute" if pct_flops >= 0.5 else "latency"
    else:
        bps = hbm_bytes / seconds
        pct_hbm = 100.0 * bps / PEAK_HBM_BPS
        row["achieved_gbps"] = round(bps / 1e9, 2)
        row["pct_peak_hbm"] = round(pct_hbm, 2)
        if pct_flops < 0.5 and pct_hbm < 0.5:
            row["bound"] = "latency"  # neither roofline wall is near
        else:
            row["bound"] = "compute" if pct_flops >= pct_hbm else "hbm"
    if note:
        row["note"] = note
    return row
