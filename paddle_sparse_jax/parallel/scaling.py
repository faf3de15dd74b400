"""Scaling-efficiency estimator for the distributed SpMM strategies.

The tests run on a virtual CPU mesh, where wall-clock says nothing about
the links between cards, so scaling is *estimated* from an analytic
roofline model:

  per-device step time  T_D = max(compute_D, comm_D)   (collectives overlap
                                                         compute under XLA's
                                                         async scheduling)
  efficiency(D)         E_D = T_1 / (D * T_D)

with per-device compute bytes = local share of the single-card SpMM
traffic at a *measured* achieved bandwidth (pass the number from
bench.py), and comm bytes by strategy:

  all_gather  (D-1)/D * N*K*b        (replicates x transiently)
  ring        same total, spread over D steps (overlaps per step)
  halo        unique-cols * K * b    (deduplicated exchange)
  2d          (Dc-1)/Dc * (M/Dr)*K*b (psum_scatter of row-block partials)

Link and memory rates come from :mod:`paddle_sparse_jax.peaks` keyed on
``device_kind``; an unknown device raises.  Pure estimate — a measured
multi-card interchange replaces it.
"""
from typing import NamedTuple, Optional

from ..peaks import peaks_for


class ScalingEstimate(NamedTuple):
    strategy: str
    n_devices: int
    compute_s: float      # per-device compute time per SpMM
    comm_s: float         # per-device interchange time per SpMM
    step_s: float         # max(compute, comm)
    efficiency: float     # T_1 / (D * T_D)
    comm_bytes: int


def _spmm_bytes(nnz: int, m: int, n: int, k: int, b: int = 4) -> int:
    # same roofline model as bench.py: indices + value + gathered rows + out
    return nnz * (2 * 4 + 4) + nnz * k * b + m * k * b


def estimate_scaling(strategy: str, n_devices: int, nnz: int, m: int,
                     n: int, k: int, *, achieved_gbps: float,
                     device_kind: str,
                     unique_cols: Optional[int] = None,
                     grid: Optional[tuple] = None,
                     elem_bytes: int = 4) -> ScalingEstimate:
    """Estimate per-device step time + scaling efficiency for one strategy.

    ``achieved_gbps``: measured single-card SpMM effective bandwidth —
    the compute model divides the local traffic share by it.  Required
    (no default): an unmeasured default would make every estimate
    fiction.  ``unique_cols``: per-device deduplicated column
    footprint for the halo strategy (defaults to min(local nnz, N)).
    ``grid``: (dr, dc) for the 2-D strategy (defaults to a near-square
    factorization of ``n_devices``).
    """
    D = n_devices
    link = peaks_for(device_kind).link_gbps
    t1 = _spmm_bytes(nnz, m, n, k, elem_bytes) / (achieved_gbps * 1e9)
    compute = t1 / D

    if strategy == "all_gather":
        comm_bytes = (D - 1) * n * k * elem_bytes // max(D, 1)
    elif strategy == "ring":
        # D-1 ppermutes of the (N/D, K) block; per-step overlap with the
        # bucket-local SpMM
        comm_bytes = (D - 1) * (n // max(D, 1)) * k * elem_bytes
    elif strategy == "halo":
        uc = unique_cols if unique_cols is not None else min(nnz // D, n)
        comm_bytes = uc * k * elem_bytes
    elif strategy == "2d":
        if grid is None:
            dr = int(D ** 0.5)
            while D % dr:
                dr -= 1
            grid = (dr, D // dr)
        dr, dc = grid
        comm_bytes = (dc - 1) * (m // dr) * k * elem_bytes // max(dc, 1)
    else:
        raise ValueError(f"unknown strategy {strategy!r}")

    comm = comm_bytes / (link * 1e9)
    step = max(compute, comm)
    eff = t1 / (D * step) if step > 0 else 1.0
    return ScalingEstimate(strategy, D, compute, comm, step, min(eff, 1.0),
                           comm_bytes)


def scaling_report(n_devices: int, nnz: int, m: int, n: int, k: int,
                   *, achieved_gbps: float, device_kind: str,
                   **kw) -> dict:
    """Estimates for every strategy at ``n_devices`` (dict for printing /
    bench detail).

    Two columns per strategy (an all-1.0 table at a compute-dominated
    measured bandwidth says nothing):

    * ``efficiency`` — at the MEASURED single-card bandwidth, where
      compute usually dominates every comm term;
    * ``efficiency_at_target`` — at 0.70 of the card's published memory
      bandwidth, where comm terms actually bind and the strategies
      separate.
    """
    hbm = peaks_for(device_kind).hbm_gbps
    target_gbps = 0.70 * hbm
    out = {}
    for s in ("all_gather", "ring", "halo", "2d"):
        e = estimate_scaling(s, n_devices, nnz, m, n, k,
                             achieved_gbps=achieved_gbps,
                             device_kind=device_kind, **kw)
        et = estimate_scaling(s, n_devices, nnz, m, n, k,
                              achieved_gbps=target_gbps,
                              device_kind=device_kind, **kw)
        out[s] = {"efficiency": round(e.efficiency, 3),
                  "efficiency_at_target": round(et.efficiency, 3),
                  "step_ms": round(e.step_s * 1e3, 3),
                  "step_ms_at_target": round(et.step_s * 1e3, 3),
                  "comm_MB": round(e.comm_bytes / 1e6, 1)}
    out["target_gbps"] = round(target_gbps, 1)
    return out