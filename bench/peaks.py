"""Published peaks of the devices a run may land on, by the name that
`torch.cuda.get_device_name()` gives: dense bf16 FLOP/s (no sparsity)
and HBM bytes/s. NVIDIA's H100 data sheet, SXM part, at its 700 W power
limit; a card set below it reads lower, so a run prints the card's limit
beside each share."""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12},
}


def peaks(kind: str) -> dict | None:
    """The peaks of device `kind`, or None for a device not in the table
    (its shares are then not reported)."""
    return PEAKS.get(kind)
