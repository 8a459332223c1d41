"""Checking evaluation results against expected values (a copy of
``yolov7_d2_tpu/evaluation/testing.py``): detectron2's ``verify_results``
over ``TEST.EXPECTED_RESULTS`` entries ``[metric, expected, tolerance]``,
and ``flatten_results`` of nested result dicts.
"""

from __future__ import annotations

import logging
from typing import Dict, Sequence

logger = logging.getLogger("yolov7_d2_tpu_torch")


def verify_results(cfg, results: Dict[str, float]) -> bool:
    """cfg.TEST.EXPECTED_RESULTS: [[metric, expected, tolerance], ...]."""
    expected: Sequence = cfg.TEST.EXPECTED_RESULTS
    if not expected:
        return True
    ok = True
    for entry in expected:
        metric, target, tol = entry[0], float(entry[1]), float(entry[2])
        actual = results.get(metric)
        if actual is None:
            logger.error(f"verify_results: metric '{metric}' missing")
            ok = False
            continue
        passed = abs(actual - target) <= tol
        level = logging.INFO if passed else logging.ERROR
        logger.log(
            level,
            f"verify_results: {metric} = {actual:.4f} "
            f"(expected {target:.4f} ± {tol:.4f}) "
            f"{'PASS' if passed else 'FAIL'}",
        )
        ok = ok and passed
    return ok


def flatten_results(results: Dict, prefix: str = "") -> Dict[str, float]:
    out: Dict[str, float] = {}
    for k, v in results.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_results(v, key))
        else:
            out[key] = float(v)
    return out
