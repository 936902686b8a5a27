"""Settings of the port and the device rule of its entry points.

Environment overrides (optional):
    OWSHEN_CHAIN_ID=<int>            protocol chain id (default 918273, the
                                     reference's src/config.rs:2)
    OWSHEN_PROVER_ENGINE=<str>       Groth16 prover MSM engine when `prove`
                                     is given none: "fixed" (default; the
                                     fixed-table engine, ops/msm_fixed.py),
                                     "lane" or "sorted" (the Pippenger
                                     engines of ops/msm.py)
    OWSHEN_PROVER_SORTED_MSM=1       the "lane" prover engine runs
                                     msm_sorted at c = 8 instead
    OWSHEN_FIXED_TABLE_MAX_GB=<num>  budget for the prover's fixed MSM
                                     tables on the card (default 40: half of
                                     an 80 GB H100, leaving room for the
                                     gathered rows and the fold); a key
                                     whose tables need more proves through
                                     "sorted", as the reference does
    OWSHEN_MSM_C=<int>               msm_sorted's window bits (default 16)
    OWSHEN_MSM_CHUNK_C=<int>         chunk width C of msm_sorted's prefix
                                     scan (default 32768: Q = n / C
                                     sequential steps of C-wide adds)
    OWSHEN_MSM_GATHER_PAD=<int>      int32 words a point row is padded to
                                     for msm_sorted's per-window gather
                                     (default: none, the row's own width,
                                     48 for G1 and 96 for G2; the reference
                                     pads to the TPU's 128-lane vreg)
    OWSHEN_NTT_PALLAS_MIN_LOGN=<int> smallest log_n that NttDomain.ntt/intt
                                     route to the fused NTT (K7, ops/ntt.py
                                     ntt_fused) instead of the stage ladder
                                     (K5); the JAX package's switch of the
                                     same name, default 31 (opt-in)

The reference's OWSHEN_MSM_PALLAS_MIN (the least width it routes to a
Pallas kernel) has no counterpart: every add and double of the port is one
kernel launch at any width.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Settings:
    chain_id: int
    prover_engine: str
    fixed_table_max_gb: float
    ntt_pallas_min_logn: int
    prover_sorted_msm: bool
    msm_window_bits: int
    msm_chunk_c: int
    msm_gather_pad: int | None


@functools.lru_cache(maxsize=None)
def settings() -> Settings:
    return Settings(
        chain_id=int(os.environ.get("OWSHEN_CHAIN_ID") or 918273),
        prover_engine=os.environ.get("OWSHEN_PROVER_ENGINE", "fixed"),
        fixed_table_max_gb=float(os.environ.get("OWSHEN_FIXED_TABLE_MAX_GB") or 40),
        ntt_pallas_min_logn=int(os.environ.get("OWSHEN_NTT_PALLAS_MIN_LOGN") or 31),
        prover_sorted_msm=os.environ.get("OWSHEN_PROVER_SORTED_MSM") == "1",
        msm_window_bits=int(os.environ.get("OWSHEN_MSM_C") or 16),
        msm_chunk_c=int(os.environ.get("OWSHEN_MSM_CHUNK_C") or 1 << 15),
        msm_gather_pad=int(os.environ["OWSHEN_MSM_GATHER_PAD"])
        if os.environ.get("OWSHEN_MSM_GATHER_PAD") else None,
    )


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  Raises when CUDA is wanted and no card is present; there is
    no silent fallback to the CPU."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
