"""Comparisons of the port's outputs with the reference's logits."""
from __future__ import annotations

from typing import List

import torch


def gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """(n,) how far each token's reference logit lies below the reference's
    best at its position, in units of that position's logit standard
    deviation (so a struck query's scale does not matter). A token outside
    the vocabulary, or a position whose reference logits are not finite,
    reads +inf."""
    ref_logits = ref_logits.float()
    best = ref_logits.amax(-1)
    std = ref_logits.std(-1).clamp(min=1e-30)
    ok = (tokens >= 0) & (tokens < ref_logits.shape[-1])
    tok = ref_logits.gather(-1, tokens.clamp(0, ref_logits.shape[-1] - 1)
                            .long()[..., None])[..., 0]
    g = (best - tok) / std
    finite = torch.isfinite(ref_logits).all(-1)
    return torch.where(ok & finite, g, torch.full_like(g, float("inf")))


def control_gaps(ref_logits: torch.Tensor, control_logits: torch.Tensor
                 ) -> torch.Tensor:
    """The gaps of the tokens the control puts first."""
    return gaps(ref_logits, control_logits.float().argmax(-1))


def logit_error(ref_logits: torch.Tensor, logits: torch.Tensor
                ) -> torch.Tensor:
    """(positions,) the mean absolute difference of ``logits`` from the
    reference's over the vocabulary, in units of the reference's logit
    standard deviation at that position."""
    ref = ref_logits.float().reshape(-1, ref_logits.shape[-1])
    other = logits.float().reshape(ref.shape)
    return (other - ref).abs().mean(-1) / ref.std(-1).clamp(min=1e-30)


def conditioned(ref32: torch.Tensor, ref64: torch.Tensor,
                tol: float = 1e-3) -> torch.Tensor:
    """(positions,) True where the float32 reference agrees with float64
    to ``tol`` (``logit_error`` units): elsewhere the result is ill-
    conditioned (a struck value of huge magnitude), and no lower
    precision can be held to it."""
    err = logit_error(ref64, ref32)
    return torch.isfinite(err) & (err < tol)


def row_medians(err: torch.Tensor, ok: torch.Tensor, rows: int
                ) -> List[float]:
    """The median of each of ``rows`` rows' well-conditioned readings
    (``err``, ``ok``: the rows' positions end to end); a row with none is
    left out."""
    err, ok = err.reshape(rows, -1), ok.reshape(rows, -1)
    return [float(err[r][ok[r]].float().median()) for r in range(rows)
            if ok[r].any()]


def summary(g: torch.Tensor) -> dict:
    """The statistics of a run's per-position readings (gaps or logit
    errors): their mean, quartiles, 90th percentile and largest, and the
    share that are not zero."""
    g = g.float()
    q = torch.quantile(g.double(), torch.tensor(
        [0.5, 0.75, 0.9], dtype=torch.float64, device=g.device)).tolist() \
        if g.numel() else [float("inf")] * 3
    return {"mean": float(g.mean()), "median": q[0], "p75": q[1], "p90": q[2],
            "max": float(g.max()), "not_first": float((g > 0).float().mean()),
            "n": int(g.numel())}
