"""The published peaks of one NVIDIA H100 SXM, which every family's
kernel bounds and the ``mfu`` reader divide by."""

PEAK_BF16_FLOPS = 989e12        # dense bf16, H100 SXM data sheet
PEAK_HBM_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet

__all__ = ["PEAK_BF16_FLOPS", "PEAK_HBM_BYTES_PER_S"]
