"""Published peak rates of one NVIDIA H100 SXM (NVIDIA data sheet, dense,
at the full 700 W power limit). A card set below 700 W runs slower, so
every share of these is printed beside the card's power limit."""

# float32 outside the tensor cores, FLOP/s (an FMA counts as two).
PEAK_F32 = 67e12
# HBM3 bytes/s.
PEAK_BYTES = 3.35e12


def least_seconds(n_bytes: float, n_ops: float,
                  peak_ops: float = PEAK_F32) -> float:
    """The least time the card could take for this many bytes moved and
    operations done: the larger of the two bounds."""
    return max(n_bytes / PEAK_BYTES, n_ops / peak_ops)
