"""Communication Configuration Generator (StarTrail / WallFacer Algs. 2-3).

The paper groups the P sequence-parallel devices into *teams* of size C.
Teams are numbered 0..P/C-1; rings ("concentric rings") are formed across
teams that belong to the same *team group* (P/C^2 teams per group), by
members sharing the same intra-team rank.

We realise the topology structurally on a 3-axis mesh factorisation of the
sequence-parallel dimension:

    (sp_grp = C, sp_ring = R, sp_team = C)        with P = C^2 * R

Device coordinates (g, j, t):
    g : team-group index          (which 1/C slice of K/V this ring covers)
    j : position within the ring  (paper: team-in-group index)
    t : intra-team rank           (paper: r_a)

The global *team* index of device (g, j, t) is tau = g*R + j and its global
sequence-parallel rank is  p = g*R*C + j*C + t  (major-to-minor (g, j, t)),
which matches ``PartitionSpec(("sp_grp", "sp_ring", "sp_team"))`` sharding
of the sequence dimension.

This module is pure Python, the port's copy of ``repro.core.topology``. The
paper's Algorithms 2 and 3 are ported verbatim (`paper_get_init_send`,
`paper_get_p2p_config`); the JAX package proves the structural versions
equivalent to them in tests/test_topology.py.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class StarTrailTopology:
    """Static description of a concentric-ring topology.

    Attributes:
      sp_size: P, total number of sequence-parallel devices.
      c: the attention-parallel size (team size / replication factor).
    """

    sp_size: int
    c: int

    def __post_init__(self):
        if self.c < 1:
            raise ValueError(f"C must be >= 1, got {self.c}")
        if self.sp_size % (self.c * self.c) != 0:
            raise ValueError(
                f"P={self.sp_size} must be divisible by C^2={self.c * self.c}"
            )
        if self.c > int(math.isqrt(self.sp_size)):
            raise ValueError(
                f"C={self.c} out of range [1, sqrt(P)={math.isqrt(self.sp_size)}]"
            )

    # ---- derived sizes -------------------------------------------------
    @property
    def ring_size(self) -> int:
        """R = P / C^2: number of devices (teams) in each sub-ring."""
        return self.sp_size // (self.c * self.c)

    @property
    def num_teams(self) -> int:
        return self.sp_size // self.c

    @property
    def num_team_groups(self) -> int:
        return self.c

    @property
    def teams_per_group(self) -> int:  # == ring_size
        return self.ring_size

    # ---- coordinate conversions ---------------------------------------
    def coords(self, rank: int) -> Tuple[int, int, int]:
        """Global SP rank -> (g, j, t)."""
        c, r = self.c, self.ring_size
        g, rem = divmod(rank, r * c)
        j, t = divmod(rem, c)
        return g, j, t

    def rank(self, g: int, j: int, t: int) -> int:
        return (g * self.ring_size + j) * self.c + t

    def team_of(self, g: int, j: int) -> int:
        return g * self.ring_size + j

    # ---- K/V assignment -------------------------------------------------
    def kv_team_at_step(self, g: int, j: int, t: int, step: int) -> int:
        """Which team's K/V chunk device (g, j, t) holds at ring step `step`.

        Step 0 is the state right after the initial placement permutation.
        The ring shifts so that device j receives from device (j+1) % R.
        """
        del g  # coverage is identical across groups by design
        jj = (j + step) % self.ring_size
        return jj * self.c + t

    # ---- permutations (linear ranks, for lax.ppermute) -------------------
    def init_placement_permutation(self) -> List[Tuple[int, int]]:
        """The paper's Alg. 2: route each team's gathered K/V to its ring slot.

        Member t' of team tau' sends the team chunk to team-group g = t',
        ring position j = tau' // C, intra rank t = tau' % C. A bijection on
        [0, P).
        """
        perm = []
        for g in range(self.c):
            for j in range(self.ring_size):
                for t in range(self.c):
                    src = self.rank(g, j, t)
                    tau = self.team_of(g, j)
                    dst = self.rank(t, tau // self.c, tau % self.c)
                    perm.append((src, dst))
        return perm

    def inverse_placement_permutation(self) -> List[Tuple[int, int]]:
        """Transpose/inverse of `init_placement_permutation` (for backward)."""
        return [(d, s) for (s, d) in self.init_placement_permutation()]

    def ring_permutation(self, shift: int = 1) -> List[Tuple[int, int]]:
        """Cyclic shift along the ring axis: device j sends to j - shift.

        With shift=+1 each device *receives* the chunk of its j+1 neighbour,
        so after s steps device j holds the chunk initially at (j+s) % R
        (consistent with `kv_team_at_step`).
        """
        perm = []
        for g in range(self.c):
            for j in range(self.ring_size):
                for t in range(self.c):
                    src = self.rank(g, j, t)
                    dst = self.rank(g, (j - shift) % self.ring_size, t)
                    perm.append((src, dst))
        return perm

    # ---- invariants (used by property tests and the scheduler) ----------
    def coverage(self, g: int, j: int, t: int) -> List[int]:
        """All K/V team chunks device (g,j,t) sees across the ring steps."""
        return [self.kv_team_at_step(g, j, t, s) for s in range(self.ring_size)]

    def check_invariants(self) -> None:
        """Paper §3.3: team members jointly cover all K/V exactly once; no
        two teams within the same ring hold identical K/V."""
        for g in range(self.c):
            for j in range(self.ring_size):
                seen: List[int] = []
                for t in range(self.c):
                    cov = self.coverage(g, j, t)
                    if len(set(cov)) != len(cov):
                        raise AssertionError("duplicate K/V within a ring")
                    seen.extend(cov)
                if sorted(seen) != list(range(self.num_teams)):
                    raise AssertionError(
                        f"team (g={g}, j={j}) does not cover all K/V exactly once: {sorted(seen)}"
                    )
        # placement permutation must be a bijection
        perm = self.init_placement_permutation()
        srcs = [s for s, _ in perm]
        dsts = [d for _, d in perm]
        assert sorted(srcs) == list(range(self.sp_size))
        assert sorted(dsts) == list(range(self.sp_size))


# ---------------------------------------------------------------------------
# Verbatim ports of the paper's Algorithms 2 and 3 (inter-team rank r_t,
# intra-team rank r_a, inter-team dimension d_t = #teams, intra-team
# dimension d_a = C). Kept for fidelity + tested equivalent to the
# structural formulation above.
# ---------------------------------------------------------------------------

def paper_get_init_send(r_t: int, r_a: int, d_t: int, d_a: int) -> int:
    """Algorithm 2: get_init_send()."""
    team_group_size = d_t // d_a
    target_team_group_rank = r_a
    target_team = target_team_group_rank * team_group_size + r_t // d_a
    target_device_intra_team_rank = r_t % d_a
    return target_team * d_a + target_device_intra_team_rank


def paper_get_p2p_config(r_t: int, r_a: int, d_t: int, d_a: int) -> Tuple[int, int]:
    """Algorithm 3: get_P2P_config() -> (next_global_rank, last_global_rank)."""
    team_group_size = d_t // d_a
    self_team_group_rank = r_t // team_group_size
    next_team_in_group = (r_t + 1) % team_group_size + team_group_size * self_team_group_rank
    last_team_in_group = (r_t - 1) % team_group_size + team_group_size * self_team_group_rank
    next_rank = r_a + next_team_in_group * d_a
    last_rank = r_a + last_team_in_group * d_a
    return next_rank, last_rank


def paper_rank(topo: StarTrailTopology, r_t: int, r_a: int) -> int:
    """Paper's flat numbering: global = team * C + intra."""
    return r_t * topo.c + r_a


def valid_c_values(sp_size: int) -> List[int]:
    """All C in [1, sqrt(P)] with P % C^2 == 0 (the scheduler's search space)."""
    out = []
    c = 1
    while c * c <= sp_size:
        if sp_size % (c * c) == 0:
            out.append(c)
        c += 1
    return out
