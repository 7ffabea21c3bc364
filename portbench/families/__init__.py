"""Model families, one module each (``families/<name>.py``), chosen by a
configuration file's ``family`` key; a file without the key is ``llama``.

A family gives what the harness needs of a model:

- ``sizes(cfg)``: the widths (``counts.Sizes``) the readers take;
- ``model_config(cfg, extra)``: the port's ``ModelConfig``, refusing a
  setting the program cannot represent;
- ``make_params(sizes, seed, device, dtype)`` and
  ``initial_leaves(sizes, seed, device, dtype)``: the seeded weights, as
  the program's parameter tree and leaf by leaf;
- ``reference``: its plain float32 module under ``portbench/reference/``
  (``strict_f32``, ``Precision``, ``hidden``, ``logits``,
  ``value_and_grad``, ``leaves``), and ``ref_cfg(sizes, cfg)``, the
  settings that module reads;
- ``serve_flops`` and ``flops_per_token``: its FLOP counts.

So a model of another family is new files: its configuration naming the
family, the family, and its reference.
"""

from __future__ import annotations

import importlib

DEFAULT = "llama"


def name(d: dict) -> str:
    """The family of a configuration file or of a run's record."""
    fam = d.get("family", DEFAULT)
    if not isinstance(fam, str) or not fam.isidentifier():
        raise ValueError(f"family {fam!r} is not a module name")
    return fam


def of(d: dict):
    """The family module of a configuration file or of a run's record."""
    return importlib.import_module(f"{__name__}.{name(d)}")
