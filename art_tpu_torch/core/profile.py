"""Profiler ranges around pipeline stages."""

from __future__ import annotations

import torch


def span(name):
    """A profiler range "art:<name>": under torch.profiler it also marks
    the device timeline from its first kernel to its last (chip_smoke.py
    reads that span per stage); close to free when no profiler runs."""
    return torch.profiler.record_function(f"art:{name}")
