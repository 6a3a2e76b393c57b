"""Symmetry work packages ("DWT clusters", paper Sec. 3).

The port's own copy of ``repro.core.clusters`` (numpy only).

Each cluster owns one fundamental-domain Wigner-d block d(l, m, m'; beta_j)
(0 <= m' <= m) and up to eight order pairs related to (m, m') by the seven
symmetries (paper Eq. 3).  Because beta-reflection equals reversing the j
axis on the Kostelec grid (beta_{2B-1-j} = pi - beta_j, w(2B-1-j) = w(j)),
every member's DWT reduces to the *same* left operand:

  forward : out[l, c] = sum_j d_rep(l, j) * rhs[j, c]
            rhs[:, c] = sign_c * w * S_member_c          (same-beta member)
            rhs[:, c] = sign_c * w * reverse_j(S_member) (reflected member)
            reflected members additionally carry a (-1)^l output sign.

  inverse : g[j, c] = sum_l d_rep(l, j) * (sign * fhat_member)[l, c],
            then reverse_j on reflected columns.

Cluster types (paper: m=0 / m'=0 / m=m' "treated in advance"):
  REG  (1 <= m' < m <= B-1): 8 members, ordered by the paper's kappa fold
  DIAG (m = m', 1 <= m):     4 members
  AXIS (m' = 0, 1 <= m):     4 members (all same-beta)
  ZERO (0, 0):               1 member

All clusters are packed into one uniform (K, 8)-slotted table; unused slots
have sign 0 and scatter to a trash cell, so the whole DWT stage is a single
batched contraction -- the agglomeration of the paper's packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import indexing

__all__ = ["ClusterTable", "build_cluster_table"]

SLOTS = 8


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: identity hash
class ClusterTable:
    """Static (numpy) metadata for the clustered DWT.

    Attributes
    ----------
    B: bandwidth.
    rep: (K, 2) int32 -- fundamental (m, m') of each cluster; REG clusters
        first in kappa order, then DIAG, AXIS, ZERO.
    fund_row: (K,) int32 -- row of the fundamental-domain Wigner table
        (sigma index m(m+1)/2 + m').
    member_m, member_mp: (K, 8) int32 -- signed orders of each slot
        (value 0 for unused slots).
    gather_m, gather_mp: (K, 8) int32 -- FFT bins (mod 2B) of each member.
    scatter_m, scatter_mp: (K, 8) int32 -- offset bins (m + B - 1) into the
        dense coefficient layout; unused slots point at the trash cell
        (2B-1, 2B-1).
    sign: (K, 8) int8 -- constant sign; 0 marks unused slots.
    reflected: (K, 8) bool -- beta-reflected members (j-reversal on the
        RHS/output and an extra (-1)^l output sign).
    n_regular: number of REG clusters (= kappa domain size).
    """

    B: int
    rep: np.ndarray
    fund_row: np.ndarray
    member_m: np.ndarray
    member_mp: np.ndarray
    gather_m: np.ndarray
    gather_mp: np.ndarray
    scatter_m: np.ndarray
    scatter_mp: np.ndarray
    sign: np.ndarray
    reflected: np.ndarray
    n_regular: int

    @property
    def n_clusters(self) -> int:
        return len(self.rep)

    def l_start(self) -> np.ndarray:
        """Per-cluster first valid degree (= m); l-extent is B - l_start."""
        return self.rep[:, 0].copy()

    def work(self) -> np.ndarray:
        """Per-cluster work in member-degree units: members * (B - m)."""
        used = (self.sign != 0).sum(axis=1)
        return used * (self.B - self.rep[:, 0])


def _members_regular(m: int, mp: int):
    """Slot table for a full 8-member cluster (1 <= m' < m)."""
    sm = (-1) ** (m - mp)
    return [
        # (m~, m~', sign_const, reflected)
        (m, mp, 1, False),
        (mp, m, sm, False),
        (-m, -mp, sm, False),
        (-mp, -m, 1, False),
        (-m, mp, (-1) ** mp, True),
        (m, -mp, (-1) ** m, True),
        (-mp, m, (-1) ** mp, True),
        (mp, -m, (-1) ** m, True),
    ]


def _members_diag(m: int):
    return [
        (m, m, 1, False),
        (-m, -m, 1, False),
        (-m, m, (-1) ** m, True),
        (m, -m, (-1) ** m, True),
    ]


def _members_axis(m: int):
    return [
        (m, 0, 1, False),
        (0, m, (-1) ** m, False),
        (-m, 0, (-1) ** m, False),
        (0, -m, 1, False),
    ]


def build_cluster_table(B: int) -> ClusterTable:
    """Build the packed cluster table for bandwidth B (host-side, O(B^2))."""
    reps: list[tuple[int, int]] = []
    members: list[list[tuple[int, int, int, bool]]] = []

    for m, mp in indexing.regular_pairs(B):  # kappa order
        reps.append((int(m), int(mp)))
        members.append(_members_regular(int(m), int(mp)))
    for m in range(1, B):
        reps.append((m, m))
        members.append(_members_diag(m))
    for m in range(1, B):
        reps.append((m, 0))
        members.append(_members_axis(m))
    reps.append((0, 0))
    members.append([(0, 0, 1, False)])

    K = len(reps)
    assert K == B * (B + 1) // 2

    rep = np.asarray(reps, dtype=np.int32)
    fund_row = (rep[:, 0].astype(np.int64) * (rep[:, 0] + 1) // 2
                + rep[:, 1]).astype(np.int32)

    member_m = np.zeros((K, SLOTS), np.int32)
    member_mp = np.zeros((K, SLOTS), np.int32)
    gather_m = np.zeros((K, SLOTS), np.int32)
    gather_mp = np.zeros((K, SLOTS), np.int32)
    trash = 2 * B - 1
    scatter_m = np.full((K, SLOTS), trash, np.int32)
    scatter_mp = np.full((K, SLOTS), trash, np.int32)
    sign = np.zeros((K, SLOTS), np.int8)
    reflected = np.zeros((K, SLOTS), bool)

    for k, mem in enumerate(members):
        for c, (mm, mmp, s, refl) in enumerate(mem):
            member_m[k, c] = mm
            member_mp[k, c] = mmp
            gather_m[k, c] = mm % (2 * B)
            gather_mp[k, c] = mmp % (2 * B)
            scatter_m[k, c] = mm + B - 1
            scatter_mp[k, c] = mmp + B - 1
            sign[k, c] = s
            reflected[k, c] = refl

    return ClusterTable(
        B=B, rep=rep, fund_row=fund_row,
        member_m=member_m, member_mp=member_mp,
        gather_m=gather_m, gather_mp=gather_mp,
        scatter_m=scatter_m, scatter_mp=scatter_mp,
        sign=sign, reflected=reflected,
        n_regular=indexing.kappa_domain_size(B),
    )
