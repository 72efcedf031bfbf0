"""Mid/side matrixing, PyTorch port of juicy_tpu/ops/shapers.py."""

from __future__ import annotations


def mid_side_encode(left, right):
    """mid = (L+R)/2, side = (L−R)/2 (JuicyWidth/PluginProcessor.cpp:114-115)."""
    return 0.5 * (left + right), 0.5 * (left - right)


def mid_side_decode(mid, side):
    """L = mid + side, R = mid − side."""
    return mid + side, mid - side
