"""Sparsity-pattern algebra for SlideSparse (paper §3, Appendix C.1).

Encodes the paper's theory as executable code:

* ``Pattern(z, l)`` — a Z:L structured-sparsity pattern (at most Z non-zeros in
  every L consecutive elements).  The paper's family is ``(2N-2):2N``.
* ``HardwarePattern(m, n)`` — an M:N hardware constraint (NVIDIA 2:4).
* ``SlideDecomposition`` — the sliding-window mapping Z:L -> M:N with stride
  ``s = n - m`` (paper App C.1.2), its window count, expansion factor ``gamma``
  (Eq. 10) and effective speedup ``S_eff = alpha / gamma`` (Cor. 1.2 / Thm 3).

All formulas are cross-checked constructively by tests/test_patterns.py.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction


@dataclasses.dataclass(frozen=True)
class Pattern:
    """Z:L structured sparsity: at most ``z`` non-zeros per ``l`` elements."""

    z: int
    l: int

    def __post_init__(self):
        if not (0 < self.z <= self.l):
            raise ValueError(f"invalid pattern {self.z}:{self.l}")

    @property
    def density(self) -> Fraction:
        return Fraction(self.z, self.l)

    @property
    def sparsity(self) -> Fraction:
        return 1 - self.density

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return f"{self.z}:{self.l}"

    @staticmethod
    def from_family(n: int) -> "Pattern":
        """The paper's (2N-2):2N family member for a given N (N >= 2)."""
        if n < 2:
            raise ValueError("family defined for N >= 2")
        return Pattern(2 * n - 2, 2 * n)

    @property
    def family_n(self) -> int | None:
        """Return N if this is a (2N-2):2N family member, else None."""
        if self.l % 2 == 0 and self.z == self.l - 2:
            return self.l // 2
        return None

    @property
    def density_speedup_bound(self) -> Fraction:
        """Theorem 3: S_eff <= L/Z = 1/density, for *any* M:N hardware."""
        return Fraction(self.l, self.z)


@dataclasses.dataclass(frozen=True)
class HardwarePattern:
    """M:N hardware sparsity support (2:4 on NVIDIA Sparse Tensor Cores)."""

    m: int
    n: int

    def __post_init__(self):
        if not (0 < self.m < self.n):
            raise ValueError(f"invalid hardware pattern {self.m}:{self.n}")

    @property
    def alpha(self) -> Fraction:
        """Nominal hardware speedup over dense: alpha = N/M."""
        return Fraction(self.n, self.m)

    @property
    def stride(self) -> int:
        """Sliding-window stride s = N - M (App C.1.2)."""
        return self.n - self.m


TWO_FOUR = HardwarePattern(2, 4)
ONE_FOUR = HardwarePattern(1, 4)  # App C.1.7: universally optimal hardware


@dataclasses.dataclass(frozen=True)
class SlideDecomposition:
    """Sliding-window decomposition of ``source`` Z:L onto ``hw`` M:N.

    Windows of size ``n`` slide across each L-element block with stride
    ``s = n - m``; adjacent windows overlap by ``m`` positions, which is what
    makes greedy residual forwarding lossless (Thm 2).
    """

    source: Pattern
    hw: HardwarePattern = TWO_FOUR

    def __post_init__(self):
        if self.source.density < self.hw_density:
            raise ValueError(
                f"{self.source} is sparser than hardware {self.hw.m}:{self.hw.n};"
                " run it natively instead (App C.1.1 constraint Z/L >= M/N)"
            )
        if (self.source.l - self.hw.n) % self.hw.stride != 0:
            raise ValueError(
                f"window of size {self.hw.n} stride {self.hw.stride} does not"
                f" tile a block of {self.source.l}"
            )
        if self.num_windows * self.hw.m < self.source.z:
            raise ValueError(
                "insufficient window capacity (violates Thm 2:"
                f" w*M = {self.num_windows * self.hw.m} < Z = {self.source.z})"
            )

    @property
    def hw_density(self) -> Fraction:
        return Fraction(self.hw.m, self.hw.n)

    @property
    def num_windows(self) -> int:
        """w = (L - N)/(N - M) + 1 (Eq. 8). For (2N-2):2N -> 2:4 this is N-1."""
        return (self.source.l - self.hw.n) // self.hw.stride + 1

    @property
    def capacity(self) -> int:
        return self.num_windows * self.hw.m

    @property
    def gamma(self) -> Fraction:
        """Expansion factor gamma = w*N / L (Eq. 9/10)."""
        return Fraction(self.num_windows * self.hw.n, self.source.l)

    @property
    def s_eff(self) -> Fraction:
        """Effective speedup alpha/gamma (Cor. 1.2). <= 1/density (Thm 3)."""
        return self.hw.alpha / self.gamma

    @property
    def achieves_density_bound(self) -> bool:
        """Whether S_eff == L/Z, i.e. the decomposition is optimal (C.1.5)."""
        return self.s_eff == self.source.density_speedup_bound

    # ---- index maps shared by slide.py / kernels -------------------------
    def window_start(self, j: int) -> int:
        """Source offset of window ``j`` within its L-block: b = s*j."""
        return self.hw.stride * j

    def lift_indices_block(self) -> list[int]:
        """Per-L-block gather indices realizing the lifting operator Psi.

        Output position n*j + d maps to source position s*j + d
        (paper Eq. 4 / Alg. 1 line 11: b = 2Ng + 2l, generalized).
        """
        idx = []
        for j in range(self.num_windows):
            for d in range(self.hw.n):
                idx.append(self.window_start(j) + d)
        return idx

    def expanded_len(self, k: int) -> int:
        """Expanded contraction length gamma*K for an input of length K."""
        if k % self.source.l:
            raise ValueError(f"K={k} not a multiple of L={self.source.l}")
        return (k // self.source.l) * self.num_windows * self.hw.n

    def compressed_len(self, k: int) -> int:
        """Length of the hardware-compressed representation: gamma*K*M/N.

        For the (2N-2):2N family onto 2:4 this equals density*K == the exact
        number of (potential) non-zeros — zero storage overhead (paper §4.3).
        """
        if k % self.source.l:
            raise ValueError(f"K={k} not a multiple of L={self.source.l}")
        return (k // self.source.l) * self.num_windows * self.hw.m


def family_table(max_n: int = 8, hw: HardwarePattern = TWO_FOUR):
    """Reproduce the paper's App C.1.5 case-analysis table."""
    rows = []
    for n in range(3, max_n + 1):
        pat = Pattern.from_family(n)
        dec = SlideDecomposition(pat, hw)
        rows.append(
            dict(
                pattern=str(pat),
                n=n,
                density=float(pat.density),
                gamma=float(dec.gamma),
                s_eff=float(dec.s_eff),
                achieves_bound=dec.achieves_density_bound,
            )
        )
    return rows
