"""Natural cubic splines for OpenSim coordinate-coupling functions
(SimmSpline / NaturalCubicSpline on a CustomJoint's TransformAxes).

PyTorch counterpart of ``inferbiomechanics_tpu/ops/spline.py``. The knot
abscissae ``x`` are structural (numpy, fixed when the skeleton is
compiled); the ordinates ``y`` may be tensors, a row per frame where each
frame has its subject's scaled knots, because the natural-cubic second
derivatives are linear in ``y``: M = S y, with S made from ``x`` alone.
Queries outside the knot range evaluate the end segment's cubic.

The segment of a query is the count of interior knots at or below it, which
equals the JAX package's clamped ``searchsorted``; the knot values are then
gathered along the last dimension. The derivative with respect to the query
is the segment polynomial's (exact everywhere except at a knot).
"""

from __future__ import annotations

import numpy as np
import torch


def natural_cubic_second_derivative_matrix(x: np.ndarray) -> np.ndarray:
    """S such that the natural-cubic second derivatives are M = S @ y.

    Standard tridiagonal system: for interior knots i=1..K-2,
      (h[i-1]/6) M[i-1] + ((h[i-1]+h[i])/3) M[i] + (h[i]/6) M[i+1]
        = (y[i+1]-y[i])/h[i] - (y[i]-y[i-1])/h[i-1]
    with natural boundaries M[0] = M[K-1] = 0.
    """
    x = np.asarray(x, np.float64)
    k = len(x)
    if k < 2:
        raise ValueError('spline needs at least 2 knots')
    if np.any(np.diff(x) <= 0):
        raise ValueError('spline knots must be strictly increasing')
    if k == 2:
        return np.zeros((2, 2))
    h = np.diff(x)
    A = np.zeros((k, k))
    B = np.zeros((k, k))
    A[0, 0] = 1.0
    A[-1, -1] = 1.0
    for i in range(1, k - 1):
        A[i, i - 1] = h[i - 1] / 6.0
        A[i, i] = (h[i - 1] + h[i]) / 3.0
        A[i, i + 1] = h[i] / 6.0
        B[i, i - 1] = 1.0 / h[i - 1]
        B[i, i] = -1.0 / h[i - 1] - 1.0 / h[i]
        B[i, i + 1] = 1.0 / h[i]
    return np.linalg.solve(A, B)


class NaturalCubicSpline:
    """A spline with structural knots ``x`` and ordinates given per call.

    ``device`` and ``dtype`` place the knot tensors, made once here so that
    an evaluation copies nothing from the host (a captured CUDA graph could
    not hold such a copy)."""

    def __init__(self, x, y=None, device='cpu', dtype=torch.float32):
        self.x = np.asarray(x, np.float64)
        self.S = natural_cubic_second_derivative_matrix(self.x)
        self.y = None if y is None else np.asarray(y, np.float64)
        self._x, self._S, self._y = (None if v is None else
                                     torch.as_tensor(v, dtype=dtype, device=device)
                                     for v in (self.x, self.S, self.y))

    def __call__(self, q: torch.Tensor, y=None) -> torch.Tensor:
        """Evaluate at ``q`` [...]. ``y`` overrides the bound ordinates: [K],
        or [..., K] with a row a query."""
        if y is None:
            if self._y is None:
                raise ValueError('no y knots bound')
            y = self._y
        x, S = self._x, self._S
        M = y @ S.T
        i = (q.unsqueeze(-1) >= x[1:-1]).sum(-1)      # the segment, 0 .. K-2
        shape = q.shape + (len(self.x),)

        def at(v, j):
            return torch.gather(v.expand(shape), -1, j.unsqueeze(-1)).squeeze(-1)

        x0, x1 = x[i], x[i + 1]
        h = x1 - x0
        a = (x1 - q) / h
        b = (q - x0) / h
        return (a * at(y, i) + b * at(y, i + 1)
                + ((a ** 3 - a) * at(M, i) + (b ** 3 - b) * at(M, i + 1))
                * (h * h) / 6.0)
