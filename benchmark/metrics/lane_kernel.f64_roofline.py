"""The float64 lane kernel's share of its roofline (`lane_roofline.py`)."""

from benchmark import lane_roofline


def read(run):
    return lane_roofline.share(run, "float64")
