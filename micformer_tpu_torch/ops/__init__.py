"""Tensor operations of the port: windows, attention, warp."""
