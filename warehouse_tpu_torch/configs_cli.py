"""Shared argparse -> EnvConfig plumbing for the port's CLI entry points
(the port's own copy of the JAX package's ``configs_cli``)."""

from __future__ import annotations

import argparse
import json

from .config import (EnvConfig, large_config, medium_config, shelves_config,
                     small_config)

PRESETS = {
    "small": small_config,
    "medium": medium_config,
    "large": large_config,
    "shelves": shelves_config,
}


def add_env_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--env", choices=sorted(PRESETS), default="medium",
                   help="preset: small=5x5/2ag, medium=9x9/4ag, "
                        "large=15x15/8ag")
    p.add_argument("--env-config", default=None,
                   help="JSON dict of EnvConfig overrides")
    p.add_argument("--global-obs", action="store_true")


def add_device_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device; the card by default")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU through the kernels' plain twins "
                        "(same as --device cpu)")


def device_from_args(args):
    """The device the caller asked for; the card unless ``--cpu`` or
    ``--device cpu``. Exits when it asks for a card and none is there."""
    from .device import resolve_device

    try:
        return resolve_device("cpu" if args.cpu else args.device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from e


def env_config_from_args(args) -> EnvConfig:
    overrides = json.loads(args.env_config) if args.env_config else {}
    if getattr(args, "global_obs", False):
        overrides["global_obs"] = True
    return PRESETS[args.env](**overrides)
