"""Signal-to-noise ratio of the negative-sampling gradient (paper §4).

Checks Theorem 2 on tabular problems where the nonparametric optimum is
known in closed form (Eq. 11): xi*_{x,y} = log(p_D(y|x) / p_n(y|x)).

Conventions: the data set holds N = X distinct feature vectors (one per row
of ``p_d``), the loss is summed over the data set (Eq. A1), and the one-
sample stochastic gradient carries the factor N (Eq. A7).

  - :func:`snr_closed_form` evaluates Eq. 15 exactly:
        1/eta = N * sum_x [ C - 2 sum_y alpha_{x,y} ],
        alpha_{x,y} = p_n sigma(xi*) = p_n p_D / (p_n + p_D)   (Eq. 13).
  - :func:`snr_empirical` Monte-Carlo estimates
        1/eta = Tr[Cov[g,g] H^-1] = sum_{x,y} E[g_{x,y}^2] / alpha_{x,y}
    from sampled stochastic gradients (Eq. A8); it agrees with the closed
    form, and is maximal at p_n = p_D (Theorem 2).

Randomness comes from a ``torch.Generator``. A draw is x uniform over the
X rows, y ~ p_D(·|x) and y' ~ p_n(·|x), each label by inverse CDF: one
float64 CDF over all X·C cells, row x offset by x, so that one
``searchsorted`` draws every sample's label from its own row. A sample then
costs O(log(X·C)), not the O(C) of a categorical draw over its row.
"""
from __future__ import annotations

import torch


def alpha(p_d: torch.Tensor, p_n: torch.Tensor) -> torch.Tensor:
    """alpha_{x,y} (Eq. 13) at the nonparametric optimum."""
    return p_d * p_n / (p_d + p_n + 1e-38)


def snr_closed_form(p_d: torch.Tensor, p_n: torch.Tensor) -> torch.Tensor:
    """eta-bar (Eq. 12) via Eq. 15. p_d, p_n: (X, C) row-stochastic."""
    n, c = p_d.shape
    inv = n * torch.sum(c - 2.0 * alpha(p_d, p_n).sum(dim=-1))
    return 1.0 / inv


class _RowSampler:
    """Inverse-CDF draws of a label from row x of a (X, C) table of
    probabilities (each row normalized to end at exactly 1.0)."""

    def __init__(self, p: torch.Tensor):
        n, self.c = p.shape
        cdf = torch.cumsum(p.double(), dim=-1)
        cdf = cdf / cdf[:, -1:]
        rows = torch.arange(n, dtype=torch.float64, device=p.device)[:, None]
        self.flat = (cdf + rows).reshape(-1)

    def __call__(self, xs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        # right=True: a zero-probability label (an empty interval) is never
        # drawn; row x's cells lie in [x, x + 1].
        pos = torch.searchsorted(self.flat, xs.double() + u, right=True)
        return (pos - xs * self.c).clamp(0, self.c - 1)


def _pieces(p_d: torch.Tensor, p_n: torch.Tensor):
    xi_star = torch.log(p_d + 1e-38) - torch.log(p_n + 1e-38)
    sig_pos = torch.sigmoid(-xi_star)      # positive-term factor sigma(-xi*)
    sig_neg = torch.sigmoid(xi_star)       # negative-term factor sigma(+xi*)
    return sig_pos, sig_neg, _RowSampler(p_d), _RowSampler(p_n)


def _draws(generator: torch.Generator, n: int, count: int, device):
    xs = torch.randint(0, n, (count,), generator=generator, device=generator.device)
    u = torch.rand((2, count), generator=generator, device=generator.device,
                   dtype=torch.float64)
    return xs.to(device), u.to(device)


def snr_empirical(p_d: torch.Tensor, p_n: torch.Tensor,
                  generator: torch.Generator, n_samples: int = 200_000,
                  chunk: int = 0) -> torch.Tensor:
    """Monte-Carlo eta-bar from stochastic gradients at the optimum,
    accumulated streamed per chunk of samples.

    The sum Tr[Cov H^-1] = sum_{x,y} E[g^2]/alpha is linear in the per-draw
    contributions g^2/alpha, so each sample's ratio is added to a float32
    scalar directly: no dense (X, C) scatter buffer. Draws come ``chunk``
    samples at a time (default ``max(64, min(8192, 2^22 // C))``, the JAX
    package's; a caller at large C passes a larger one, since every chunk
    is a host iteration).

    Per-sample accumulation re-associates the float32 sums relative to the
    scatter-then-divide order of :func:`snr_empirical_dense`, so the two
    agree to Monte-Carlo tolerance, not bit for bit; given the same
    generator state, ``n_samples`` and ``chunk`` this estimator is itself
    bitwise deterministic.
    """
    n, c = p_d.shape
    sig_pos, sig_neg, draw_d, draw_n = _pieces(p_d, p_n)
    a = alpha(p_d, p_n) + 1e-38
    if not chunk:
        # Keep the JAX package's chunk, sized there for a (chunk, C)
        # categorical workspace of ~16 MB.
        chunk = int(max(64, min(8192, (1 << 22) // max(c, 1))))
    n_chunks = -(-n_samples // chunk)
    total = torch.zeros((), dtype=torch.float32, device=p_d.device)
    for _ in range(n_chunks):
        xs, u = _draws(generator, n, chunk, p_d.device)
        ys, yns = draw_d(xs, u[0]), draw_n(xs, u[1])
        # g-hat (Eq. A8): -N sigma(-xi_{x,y}) at (x,y), +N sigma(xi_{x,y'})
        # at (x,y'); the entries coincide when y == y'.
        g_pos = -n * sig_pos[xs, ys]
        g_neg = n * sig_neg[xs, yns]
        term = torch.where(ys == yns,
                           (g_pos + g_neg) ** 2 / a[xs, ys],
                           g_pos ** 2 / a[xs, ys] + g_neg ** 2 / a[xs, yns])
        total = total + term.sum()
    return 1.0 / (total / (n_chunks * chunk))


def snr_empirical_dense(p_d: torch.Tensor, p_n: torch.Tensor,
                        generator: torch.Generator,
                        n_samples: int = 200_000) -> torch.Tensor:
    """Reference estimator with the dense (X, C) scatter accumulation, kept
    for small-C cross-checks of :func:`snr_empirical` (it needs all
    ``n_samples`` draws and an (X, C) buffer at once)."""
    n, c = p_d.shape
    sig_pos, sig_neg, draw_d, draw_n = _pieces(p_d, p_n)
    xs, u = _draws(generator, n, n_samples, p_d.device)
    ys, yns = draw_d(xs, u[0]), draw_n(xs, u[1])
    g_pos = -n * sig_pos[xs, ys]
    g_neg = n * sig_neg[xs, yns]
    same = ys == yns
    sq = torch.zeros((n, c), dtype=torch.float32, device=p_d.device)
    sq.index_put_((xs, ys), torch.where(same, (g_pos + g_neg) ** 2, g_pos ** 2),
                  accumulate=True)
    sq.index_put_((xs, yns), torch.where(same, torch.zeros_like(g_neg), g_neg ** 2),
                  accumulate=True)
    second_moment = sq / n_samples          # E[g_{x,y}^2] over the full draw
    return 1.0 / torch.sum(second_moment / (alpha(p_d, p_n) + 1e-38))
