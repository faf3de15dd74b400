"""Published peak rates of the cards this package is measured on, keyed
by the ``device_kind`` JAX reports (prefix match).  A device that is not
in the table is an error, not a default.

Source: NVIDIA H100 Tensor Core GPU data sheet (SXM5 part; dense rates,
no sparsity), at the full 700 W power limit.  A card set below that
limit cannot hold its top clock under load, so every measurement records
the card's power limit beside it.
"""
from typing import NamedTuple


class Peaks(NamedTuple):
    hbm_gbps: float          # device memory bandwidth, GB/s
    link_gbps: float         # NVLink to the other cards, GB/s each way
    bf16_tflops: float       # dense tensor-core rate
    f32_tflops: float        # outside the tensor cores
    hbm_gb: float            # device memory size


PEAKS = {
    "NVIDIA H100": Peaks(hbm_gbps=3350.0, link_gbps=450.0,
                         bf16_tflops=989.0, f32_tflops=67.0, hbm_gb=80.0),
}


def peaks_for(device_kind: str) -> Peaks:
    for kind, peaks in PEAKS.items():
        if device_kind.lower().startswith(kind.lower()):
            return peaks
    raise KeyError(f"no published peaks for device kind {device_kind!r}; "
                   f"known: {sorted(PEAKS)}")
