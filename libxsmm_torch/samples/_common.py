"""What the samples share: the --device option and the clock."""

from __future__ import annotations

import argparse
from typing import Sequence, Tuple

import torch

from ..utils.timer import bench_chain_interleaved, bench_host_interleaved


def add_device(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the card) or cpu (the "
                         "kernels' plain versions)")
    return ap


def device(name: str) -> torch.device:
    """The sample's device; raises for the card when there is none, so a
    sample never carries on on the CPU unless asked to."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is present; pass --device cpu "
                           "to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cuda":
        # f32 means f32: no TF32 in the port or in the references beside it
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def clock(dev: torch.device) -> str:
    """The label of the times taken on `dev`."""
    return ("card, CUDA events" if dev.type == "cuda"
            else "CPU, host clock: not a card figure")


def timed(cands: Sequence[Tuple], dev: torch.device, reps: int = 20,
          rounds: int = 3):
    """Best seconds per call of each (fn, args) candidate, their windows
    interleaved round by round: CUDA events on the card, the host clock on
    the CPU (see clock())."""
    if dev.type == "cuda":
        return bench_chain_interleaved(cands, reps=reps, rounds=rounds)
    return bench_host_interleaved(cands, reps=reps, rounds=rounds)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
