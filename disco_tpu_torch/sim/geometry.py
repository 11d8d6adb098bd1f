"""Scenario sampling: room geometry, node/source placement, mic arrays (the
port's copy of ``disco_tpu/sim/geometry.py``: host numpy, the same draws in
the same order, so one ``Generator`` state gives the same arrays bit for bit
in both packages).

Capability parity with reference ``dataset_utils/room_setups.py`` (the
``RandomRoomSetup:7`` / ``MeetingRoomSetup:255`` / ``LivingRoomSetup:386`` /
``MeetitSetup:454`` classes).  Rejection sampling is control-flow heavy and
cheap, so it stays host-side NumPy; the sampled geometry feeds the batched
image-source model (``disco_tpu_torch.sim.ism``).

Differences from the reference, by design:
* randomness flows through an explicit ``numpy.random.Generator`` (the
  reference mutates the global seed),
* a bounded number of *whole-configuration* retries with a clear error
  instead of an unbounded ``while`` loop,
* ``d_nw`` et al. keep the reference's exact constraint semantics, including
  LivingRoom's reinterpretation of ``d_mw`` as a *maximum* wall distance
  (room_setups.py:395-402).
"""
from __future__ import annotations

import dataclasses

import numpy as np

MAX_TRIALS = 100  # the reference's per-placement retry bound (room_setups.py:123)


def circular_array_2d(center, n_mics: int, phi0: float, radius: float) -> np.ndarray:
    """(2, n_mics) positions on a circle — pra.circular_2D_array semantics
    (room_setups.py:228-231)."""
    ang = phi0 + 2.0 * np.pi * np.arange(n_mics) / n_mics
    return np.asarray(center)[:, None] + radius * np.stack([np.cos(ang), np.sin(ang)])


def eyring_absorption(rt60: float, length: float, width: float, height: float) -> float:
    """Uniform wall absorption from RT60 via the reference's Eyring-like fit
    ``alpha = 1 - exp((1.7e-5·RT60 - 0.1611)·V/(RT60·S))`` (room_setups.py:92)."""
    vol = length * width * height
    sur = 2 * (length * width + length * height + width * height)
    return 1.0 - np.exp((1.7e-5 * rt60 - 0.1611) * vol / (rt60 * sur))


def _uniform(rng, lo, hi):
    return lo + (hi - lo) * rng.random()


@dataclasses.dataclass
class RoomSetup:
    """Sampled configuration: everything the simulator needs."""

    length: float
    width: float
    height: float
    alpha: float
    beta: float  # RT60 in seconds
    nodes_centers: np.ndarray  # (n_nodes, 3)
    source_positions: np.ndarray  # (n_sources, 3)
    mic_positions: np.ndarray  # (3, total_mics) — pra layout

    @property
    def room_dim(self) -> np.ndarray:
        return np.array([self.length, self.width, self.height])

    def plot(self):
        """Top-view Figure of the sampled configuration — room outline, node
        centers, microphones and sources (the ``plot_room`` observability
        helper of reference room_setups.py:238-253; the from-saved-infos
        variant is ``disco_tpu_torch.enhance.inference.plot_conf``).  Returns
        the matplotlib Figure — save with ``fig.savefig(...)``."""
        from disco_tpu_torch.utils.plotting import draw_room_topview

        return draw_room_topview(
            self.length, self.width, self.mic_positions, self.source_positions,
            self.nodes_centers,
        )


class RandomRoomSetup:
    """Uniformly random nodes + sources under min-distance constraints
    (room_setups.py:7-236)."""

    def __init__(
        self,
        l_range, w_range, h_range, beta_range,
        n_sensors_per_node, d_mw, d_mn, d_nn, z_range_m,
        d_rnd_mics,
        n_sources, d_ss, d_sn, d_sw, z_range_s,
        rng=None, **kwargs,
    ):
        self.sensors_per_node = list(n_sensors_per_node)
        self.n_nodes = len(self.sensors_per_node)
        self.d_mw, self.d_mn = d_mw, d_mn
        self.d_nw = d_mw + d_mn
        self.d_rnd_mics = d_rnd_mics
        self.d_nn = d_nn
        self.n_sources = n_sources
        self.d_ss, self.d_sn, self.d_sw = d_ss, d_sn, d_sw
        self.z_range_m, self.z_range_s = z_range_m, z_range_s
        self.l_range, self.w_range, self.h_range, self.beta_range = l_range, w_range, h_range, beta_range
        self.rng = np.random.default_rng() if rng is None else rng
        # Sampled state (populated by create_room_setup)
        self.length = self.width = self.height = self.alpha = self.beta = None
        self.nodes_centers = self.source_positions = self.microphones_positions = None

    # -- room ---------------------------------------------------------------
    def set_room_dimensions(self):
        """Sample (length, width, height, alpha, beta) (room_setups.py:81-94)."""
        length = _uniform(self.rng, *self.l_range)
        width = _uniform(self.rng, *self.w_range)
        height = _uniform(self.rng, *self.h_range)
        beta = _uniform(self.rng, *self.beta_range)
        alpha = eyring_absorption(beta, length, width, height)
        return length, width, height, alpha, beta

    # -- nodes --------------------------------------------------------------
    def _sample_node_xy(self):
        return (
            _uniform(self.rng, self.d_nw, self.length - self.d_nw),
            _uniform(self.rng, self.d_nw, self.width - self.d_nw),
        )

    def get_nodes_centers(self):
        """Nodes ≥ d_nw from walls, pairwise ≥ d_nn apart in the xy plane
        (room_setups.py:96-134)."""
        centers = np.zeros((self.n_nodes, 3))
        x0, y0 = self._sample_node_xy()
        centers[0] = x0, y0, _uniform(self.rng, *self.z_range_m)
        n_trials = 0
        for i in range(1, self.n_nodes):
            x, y = self._sample_node_xy()
            z = _uniform(self.rng, *self.z_range_m)
            while (
                np.any(np.sum((centers[:i, :2] - [x, y]) ** 2, axis=1) < self.d_nn**2)
                and n_trials < MAX_TRIALS
            ):
                x, y = self._sample_node_xy()
                n_trials += 1
            if n_trials >= MAX_TRIALS:
                return centers, n_trials
            centers[i] = x, y, z
            n_trials = 0
        return centers, n_trials

    # -- sources ------------------------------------------------------------
    def _sample_source_xy(self):
        return (
            _uniform(self.rng, self.d_sw, self.length - self.d_sw),
            _uniform(self.rng, self.d_sw, self.width - self.d_sw),
        )

    def get_source_positions(self):
        """Sources ≥ d_sw from walls, ≥ d_sn from every node, ≥ d_ss from
        each other (room_setups.py:162-211)."""
        pos = np.zeros((self.n_sources, 3))
        n_trials = 0
        for i in range(self.n_sources):
            x, y = self._sample_source_xy()
            z = _uniform(self.rng, *self.z_range_s)
            while (
                (
                    np.any(np.sum((pos[:i, :2] - [x, y]) ** 2, axis=1) < self.d_ss**2)
                    or np.any(np.sum((self.nodes_centers[:, :2] - [x, y]) ** 2, axis=1) < self.d_sn**2)
                )
                and n_trials < MAX_TRIALS
            ):
                x, y = self._sample_source_xy()
                n_trials += 1
            if n_trials >= MAX_TRIALS:
                return pos, n_trials
            pos[i] = x, y, z
            n_trials = 0
        return pos, n_trials

    def get_random_mics_positions(self):
        """Two extra mics ≥ d_rnd_mics apart (the diffuse-noise pair,
        room_setups.py:136-160)."""
        m1 = [*self._sample_node_xy(), _uniform(self.rng, *self.z_range_m)]
        m2x, m2y = self._sample_node_xy()
        while np.hypot(m1[0] - m2x, m1[1] - m2y) < self.d_rnd_mics:
            m2x, m2y = self._sample_node_xy()
        return m1, [m2x, m2y, m1[2]]

    # -- mics ---------------------------------------------------------------
    def add_circular_microphones(self):
        """Circular sub-array of radius d_mn at each node center, random
        phase, constant z (room_setups.py:213-236).  (3, total_mics)."""
        total = int(np.sum(self.sensors_per_node))
        mics = np.zeros((3, total))
        at = 0
        for i in range(self.n_nodes):
            m = self.sensors_per_node[i]
            mics[:2, at : at + m] = circular_array_2d(
                self.nodes_centers[i][:2], m, np.pi / 2 * self.rng.random(), self.d_mn
            )
            mics[2, at : at + m] = self.nodes_centers[i][2]
            at += m
        return mics

    # -- driver -------------------------------------------------------------
    def create_room_setup(self, max_config_trials: int = 1000) -> RoomSetup:
        """Rejection-sample a full configuration (room_setups.py:57-79)."""
        for _ in range(max_config_trials):
            self.length, self.width, self.height, self.alpha, self.beta = self.set_room_dimensions()
            centers, t_nodes = self.get_nodes_centers()
            if t_nodes >= MAX_TRIALS:
                continue
            self.nodes_centers = centers
            sources, t_src = self.get_source_positions()
            if t_src >= MAX_TRIALS:
                continue
            self.source_positions = sources
            self.microphones_positions = self.add_circular_microphones()
            return RoomSetup(
                self.length, self.width, self.height, self.alpha, self.beta,
                self.nodes_centers, self.source_positions, self.microphones_positions,
            )
        raise RuntimeError("no valid room configuration found; relax the constraints")


class MeetingRoomSetup(RandomRoomSetup):
    """Nodes on a round table, two sources around it (room_setups.py:255-383)."""

    def __init__(self, r_range, d_nt_range, d_st_range, phi_ss_range=None, phi_ss_choice=None, **kwargs):
        super().__init__(**kwargs)
        self.r_range = r_range
        self.d_nt_range, self.d_st_range = d_nt_range, d_st_range
        self.phi_ss_range, self.phi_ss_choice = phi_ss_range, phi_ss_choice
        self.d_nt = self.d_st = self.phi_t = None
        self.table_center = self.table_radius = None
        self.d_max = None

    def get_table_position(self):
        """(room_setups.py:285-304)."""
        r = _uniform(self.rng, *self.r_range)
        self.d_max = min(self.d_nt_range[1], r - self.d_mn)
        self.d_nt = self.d_max / 2
        self.d_st = _uniform(self.rng, self.d_st_range[0], self.d_max)
        dt_min = self.d_sw + self.d_st + r
        x_t = _uniform(self.rng, dt_min, self.length - dt_min)
        y_t = _uniform(self.rng, dt_min, self.width - dt_min)
        z_t = _uniform(self.rng, *self.z_range_m)
        self.table_center = (x_t, y_t, z_t)
        self.table_radius = r
        return self.table_center, self.table_radius

    def get_nodes_angles(self):
        """(room_setups.py:328-336)."""
        angles = self.phi_t + np.linspace(
            0, 2 * (self.n_nodes - 1) * np.pi / self.n_nodes, self.n_nodes
        )
        proj = np.array([np.cos(angles), np.sin(angles)]).T
        return angles, proj

    def get_nodes_centers(self):
        """Nodes on the table with a random radial jitter (room_setups.py:306-326)."""
        centers = np.zeros((self.n_nodes, 3))
        table_center, table_radius = self.get_table_position()
        self.phi_t = 2 * np.pi / self.n_nodes * self.rng.random()
        centers[:, :2] = circular_array_2d(
            table_center[:2], self.n_nodes, self.phi_t, table_radius - self.d_nt
        ).T
        proj = self.get_nodes_angles()[1]
        radial = -self.d_nt + (self.d_max - self.d_nt_range[0]) * self.rng.random((self.n_nodes, 1))
        centers[:, :2] += radial * proj
        centers[:, 2] = table_center[2]
        return centers, 0

    def get_source_positions(self):
        """Two sources at table_radius + d_st, constrained relative angle
        (room_setups.py:338-366)."""
        phi_st = 2 * np.pi * self.rng.random()
        d = self.table_radius + self.d_st
        if self.phi_ss_range is not None:
            phi_ss = _uniform(self.rng, *self.phi_ss_range)
        elif self.phi_ss_choice is not None:
            phi_ss = self.phi_ss_choice[self.rng.integers(len(self.phi_ss_choice))]
        else:
            raise AttributeError("either phi_ss_range or phi_ss_choice must be given")
        pos = np.zeros((2, 3))
        for i, phi in enumerate((self.phi_t + phi_st, self.phi_t + phi_st + phi_ss)):
            pos[i] = (
                self.table_center[0] + d * np.cos(phi),
                self.table_center[1] + d * np.sin(phi),
                _uniform(self.rng, *self.z_range_s),
            )
        return pos, 0


class LivingRoomSetup(RandomRoomSetup):
    """Three nodes near three distinct walls + one free node; d_mw is the
    MAX wall distance here (room_setups.py:386-451)."""

    D_MW_MIN = 0.02  # hard-coded minimal mic-wall distance (room_setups.py:401)

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.d_nw = self.d_mw - self.d_mn

    def get_nodes_centers(self):
        centers = np.zeros((self.n_nodes, 3))
        d_max = self.d_nw
        d_min = self.D_MW_MIN + self.d_mn
        # One candidate near each of the four walls; keep a random three.
        vert_x = np.array([
            _uniform(self.rng, d_min, d_max),
            _uniform(self.rng, self.length - d_max, self.length - d_max + (d_max - d_min)),
        ])
        vert_y = d_min + (self.width - d_min) * self.rng.random(2)
        hori_x = d_min + (self.length - d_min) * self.rng.random(2)
        hori_y = np.array([
            _uniform(self.rng, d_min, d_max),
            _uniform(self.rng, self.width - d_max, self.width - d_max + (d_max - d_min)),
        ])
        z = self.z_range_m[0] + (self.z_range_m[1] - self.z_range_m[0]) * self.rng.random(4)
        candidates = np.array([
            [vert_x[0], vert_y[0], z[0]],
            [vert_x[1], vert_y[1], z[1]],
            [hori_x[0], hori_y[0], z[2]],
            [hori_x[1], hori_y[1], z[3]],
        ])
        centers[:3] = self.rng.permutation(candidates)[:3]
        # Remaining nodes: free placement under the pairwise constraint.
        n_trials = 0
        for i in range(3, self.n_nodes):
            x, y = self._sample_node_xy()
            zi = _uniform(self.rng, *self.z_range_m)
            while (
                np.any(np.sum((centers[:i, :2] - [x, y]) ** 2, axis=1) < self.d_nn**2)
                and n_trials < MAX_TRIALS
            ):
                x, y = self._sample_node_xy()
                n_trials += 1
            if n_trials >= MAX_TRIALS:
                return centers, n_trials
            centers[i] = x, y, zi
            n_trials = 0
        return centers, n_trials


class MeetitSetup(MeetingRoomSetup):
    """Sources directly facing equally spaced nodes (room_setups.py:454-483)."""

    def get_source_positions(self):
        pos = np.zeros((self.n_nodes, 3))
        pos[:, :2] = circular_array_2d(
            self.table_center[:2], self.n_nodes, self.phi_t, self.table_radius + self.d_st
        ).T
        pos[:, 2] = [_uniform(self.rng, *self.z_range_s) for _ in range(self.n_nodes)]
        n_trials = 0
        if (
            np.any(pos[:, :2] <= self.d_sw)
            or np.any(pos[:, 0] >= self.length - self.d_sw)
            or np.any(pos[:, 1] >= self.width - self.d_sw)
        ):
            n_trials = MAX_TRIALS
        return pos, n_trials
