"""Whether the served answers are right.

Every answer a run received (warm-up load, window and drain) is held
against the plain reference's answer for the same pool image: the reference
(``reference/``) calibrates from the same float weights and calibration
image on its own, runs the fixed-point forward of every pool image exactly,
and gives each image's class probabilities in float64.  The numbers
compared, each against the limit that the configuration file states under
``check``:

- ``prob_gap``: the widest gap between a served class probability and the
  reference's, as a share of the reference's (denominators below 1e-20
  count as 1e-20).  The program's softmax runs in float32, so a sound run
  reads its rounding; one int8 logit off by one step moves that class's
  probability by about 2^-f, f the logits' fraction.
- ``malformed``: answers of the wrong size, or not finite (limit 0).
- ``unanswered``: requests that raised or never came back (limit 0).
"""
from __future__ import annotations

import torch

from portbench.reference.model import FixedPointModel

FLOOR = 1e-20


def reference_answers(layers, weights: dict, calib, pool, f_img: int,
                      bits: int = 8, block: int = 8) -> tuple:
    """(P, classes) float64 probabilities of the reference (``bits`` = 8)
    or the lower-precision control (4) for each pool image, and the
    calibrated model."""
    ref = FixedPointModel(layers, weights, calib, bits=bits)
    return torch.cat([ref.forward(pool[i:i + block], f_img)
                      for i in range(0, pool.shape[0], block)]), ref


def compare(answers: list, want: torch.Tensor, unanswered: int) -> dict:
    """The compared numbers for ``answers``, pieces (pool indices, host
    tensor of their answers), against the reference's probabilities
    ``want`` (P, classes)."""
    classes = want.shape[1]
    gap, bad = 0.0, 0
    for ks, host in answers:
        if host.dtype != torch.float32 or host.numel() != len(ks) * classes:
            bad += len(ks)
            continue
        got = host.reshape(len(ks), classes).to(want.device, torch.float64)
        finite = torch.isfinite(got).all(dim=1)
        bad += int((~finite).sum())
        ref = want[torch.tensor(ks, device=want.device)][finite]
        if ref.numel():
            g = (got[finite] - ref).abs() / ref.clamp(min=FLOOR)
            gap = max(gap, float(g.max()))
    return {"prob_gap": gap, "malformed": bad, "unanswered": unanswered}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): each number at or under its
    limit; ``malformed`` and ``unanswered`` have the limit 0."""
    lim = {"malformed": 0, "unanswered": 0, **limits}
    checks = {k: {"value": v, "limit": lim[k]} for k, v in numbers.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
