"""Everything the harness does that depends on the network lives in one
module a family, ``vosbench/networks/<family>.py``, which a configuration
file names by its ``network`` key. A configuration of a family that is
there is one JSON file; a new family is one new module besides.

Every family module exposes:

* ``check(cfg)``: raises ``ValueError`` naming each missing or
  inconsistent key of the configuration;
* ``feature_hw(cfg, h, w)``: the feature grid of an (h, w) frame;
* ``frame_flops(cfg, h, w)``: the encoder's operations on one frame;
* ``train_forward_flops(cfg, n, crop)``: the forward's operations over
  ``n`` training crops of crop x crop;
* ``inference_weights(cfg, seed, frames_u8, device)``: the weights from the
  seed, made ready on the cell's frames, as a flat state dict;
* ``train_weights(cfg, seed, device)``: the weights training starts from;
* ``parameter_keys(sd)``: the trainable leaves of a state dict;
* ``forward(sd, cfg, x, bn=None, round_to=None)``: the plain float32
  reference, (N, 3, H, W) normalised frames → (N, feature_dim, hd, wd),
  with ``bn`` the BatchNorm to use (a family without BatchNorm ignores it)
  and every activation rounded to ``round_to`` where given (the control);
* ``program_net(cfg, sd, device)``: the port's network with ``sd`` loaded,
  as the CLI builds it;
* ``wrap(tracer)``: the encoder's own ranges and ``tracer.claim`` calls in
  a traced run.

Only ``program_net`` and ``wrap`` import the port, inside the function.
"""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path
from types import ModuleType
from typing import Optional

HERE = Path(__file__).resolve().parent
FUNCTIONS = ("check", "feature_hw", "frame_flops", "train_forward_flops", "inference_weights", "train_weights",
             "parameter_keys", "forward", "program_net", "wrap")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def of(cfg: dict, root: Optional[Path] = None) -> ModuleType:
    """The family module that ``cfg["network"]`` names, from
    ``root/vosbench/networks/`` (this directory without ``root``), once it
    has every function and ``check(cfg)`` has passed."""
    name = cfg.get("network")
    model = cfg.get("model")
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"configuration {model!r}: the key network names no family module ({name!r})")
    path = (HERE if root is None else Path(root) / "vosbench" / "networks") / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"configuration {model!r}: unknown network {name!r} (no {path})")
    spec = importlib.util.spec_from_file_location(f"vosbench_network_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    missing = [f for f in FUNCTIONS if not callable(getattr(module, f, None))]
    if missing:
        raise ValueError(f"network {name!r} ({path}) lacks {', '.join(missing)}")
    module.check(cfg)
    return module
