"""The card a run measures: its presence, its name, its power limit and its
published peaks (``kubench/peaks.json``)."""

from __future__ import annotations

import json
import subprocess

from kubench.harness.spec import BENCH


class NoCard(RuntimeError):
    """The run found fewer cards than its cell asks for."""


def require(torch, chips: int):
    """The first card, or :class:`NoCard`: a run never falls back to the
    CPU."""
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: no card, no result")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, torch sees "
                     f"{torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def peaks(name: str) -> dict:
    """The first row of ``peaks.json`` whose ``match`` is in the card's
    name: dense FLOP/s by precision and bytes/s of device memory."""
    for row in json.loads((BENCH / "peaks.json").read_text())["cards"]:
        if row["match"] in name:
            return row
    raise NoCard(f"no published peaks in peaks.json for {name!r}")


def power_line() -> str:
    """``name, power.limit`` as nvidia-smi reports them for card 0."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip() or f"nvidia-smi said nothing ({out.stderr.strip()})"
