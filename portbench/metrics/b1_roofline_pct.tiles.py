"""B1's least time over the device time of its kernels in the traced
stretch, for the tile cells."""

from yardstick.shares import b1_roofline_pct as read  # noqa: F401
