"""Hand-written Hopper kernels of the port, each beside its plain version.

Every wrapper adds one to ``launch_counts[<kernel>]`` where it launches its
kernel, and nowhere else, so a run can show that its main path went through
the kernels (``chip_smoke.py`` zeroes the counts, drives the path, reads
them).
"""
from collections import Counter

launch_counts: Counter = Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()
