"""Alpha-beta coefficient fitting from measured timings.

PyTorch-port copy of ``stencil_tpu/tuning/fit.py`` (reference:
src/machine.cu, bin/pingpong.cu measure the machine before planning):
the two-parameter model

    seconds(message) = alpha + bytes / beta

fitted by least squares to ring-shift timings at several message sizes.
The fitted ``LinkCoefficients`` replace the assumed constants of
``analysis/costmodel.py`` when the tuner ranks its candidates.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

from ..analysis.costmodel import LinkCoefficients

#: message sizes the calibration samples: one latency-dominated, one
#: bandwidth-dominated, one in between (least squares over all three)
DEFAULT_CALIBRATION_BYTES: Tuple[int, ...] = (1 << 12, 1 << 17, 1 << 21)


def fit_alpha_beta(samples: Sequence[Tuple[int, float]]
                   ) -> LinkCoefficients:
    """Least-squares fit of ``seconds = alpha + bytes / beta`` over
    ``(bytes, seconds)`` samples. Degenerate inputs (a single sample,
    or zero byte spread) attribute everything to latency."""
    if not samples:
        raise ValueError("fit_alpha_beta needs at least one sample")
    if len(samples) == 1 or len({b for b, _ in samples}) == 1:
        alpha = max(min(t for _, t in samples), 1e-12)
        return LinkCoefficients(alpha_s=alpha, beta_bytes_per_s=1e30)
    n = len(samples)
    sx = sum(float(b) for b, _ in samples)
    sy = sum(float(t) for _, t in samples)
    sxx = sum(float(b) * float(b) for b, _ in samples)
    sxy = sum(float(b) * float(t) for b, t in samples)
    denom = n * sxx - sx * sx
    slope = (n * sxy - sx * sy) / denom     # seconds per byte = 1/beta
    alpha = (sy - slope * sx) / n
    # noisy small-sample fits can cross zero; clamp to physical values
    alpha = max(alpha, 1e-12)
    beta = 1.0 / slope if slope > 0 else 1e30
    return LinkCoefficients(alpha_s=alpha, beta_bytes_per_s=beta)


def calibrate_link(pingpong: Callable[[int], float],
                   sizes: Sequence[int] = DEFAULT_CALIBRATION_BYTES
                   ) -> LinkCoefficients:
    """Measure ``pingpong(nbytes)`` (seconds per neighbour shift of one
    ``nbytes`` message) at each size and fit the alpha-beta model."""
    return fit_alpha_beta([(int(b), float(pingpong(int(b))))
                           for b in sizes])


def coefficients_record(coeffs_by_link: Dict[str, LinkCoefficients]
                        ) -> Dict[str, Dict[str, float]]:
    """JSON-ready form for the plan cache."""
    return {link: {"alpha_s": c.alpha_s,
                   "beta_bytes_per_s": c.beta_bytes_per_s}
            for link, c in coeffs_by_link.items()}
