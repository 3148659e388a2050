"""Cells cut to a tiny size for the CPU: a few envs of 16^2, short segments."""

import time

import torch

from portbench import core, runner

CPU = torch.device("cpu")


def tiny_cell(name: str) -> core.Cell:
    cell = core.resolve_cell(name)
    cell.config["fleet"].update(num_envs=8, grid=16, end_time=0.05)
    cell.traffic.update(segment_steps=4, warmup_segments=1, trace_segments=3, check_segments=2)
    cell.limits["check_envs"] = 6
    return cell


def run(cell: core.Cell, seed: int, traced: bool = False):
    """One run of ``cell`` on the CPU; returns ``(checks, result)``."""
    out = runner.run_cell(cell, seed, 0.3, traced, time.perf_counter(), device=CPU)
    return out["checks"], out["result"]
