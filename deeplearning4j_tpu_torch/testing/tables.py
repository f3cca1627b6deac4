"""Tuning tables for the card tests that drive kernels at small shapes.

A card's checked-in table (``ops/tuning_tables/<kind>.json``) sends calls
below its measured crossovers to the generic: on the H100 a float32
fused matmul under M 1024 takes cuBLAS. A test that counts a kernel's
launches at a few rows would then count none, and a test of a kernel's
own state (the K-major weight copy) would test cuBLAS instead.
:func:`pin_default_table` makes such a test dispatch by ``default.json``
alone (every eligible call to its kernel), with an empty cache directory
of its own; the test that holds the card's table undoes it.
"""

from __future__ import annotations

import os

from deeplearning4j_tpu_torch.ops import tuning


def pin_default_table(monkeypatch, cache_dir) -> None:
    """Dispatch by ``default.json`` alone until ``monkeypatch`` is undone
    (then call ``tuning.reset_tables()``): no device kind's table and no
    measured table in ``cache_dir`` (which should be empty) is read."""
    default = os.path.join(tuning._PACKAGE_TABLE_DIR, "default.json")
    monkeypatch.setattr(tuning, "default_table_paths",
                        lambda kind: [default])
    monkeypatch.setenv(tuning.ENV_DIR, str(cache_dir))
    tuning.reset_tables()
